"""nadavca_tpu — nanopore raw-signal alignment and SNP calling in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``fmfi-compbio/nadavca`` (see SURVEY.md): raw squiggle→reference alignment via
a banded Viterbi (CUDA kernels on an NVIDIA GPU, lax.scan elsewhere), and
signal-level SNP calling via fused posterior ops, data-parallel over device
meshes.
"""

from .api import ReadAlignment, align_signal, call_snps
from .call import SnpCall
from .config import AlignConfig, DEFAULT_CONFIG
from .genome import Genome, encode_bases, decode_bases, reverse_complement, kmer_ids
from .kmer_model import KmerModel, default_model

__version__ = "0.1.0"

__all__ = [
    "AlignConfig",
    "DEFAULT_CONFIG",
    "Genome",
    "KmerModel",
    "ReadAlignment",
    "SnpCall",
    "align_signal",
    "call_snps",
    "default_model",
    "encode_bases",
    "decode_bases",
    "reverse_complement",
    "kmer_ids",
]
