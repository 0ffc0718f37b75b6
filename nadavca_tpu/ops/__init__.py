"""Compute ops: banded DP (numpy spec, lax.scan, CUDA kernels), SNP scoring."""
