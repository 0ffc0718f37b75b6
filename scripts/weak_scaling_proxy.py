"""Weak-scaling proxy for the multi-host SNP pipeline (BASELINE.json config 5).

Real multi-host scaling needs a cluster; the honest substitute is N local
jax.distributed CPU processes with the SAME
per-process read count (weak scaling): per-process throughput should stay
flat as N grows if the collective merge is not a bottleneck. This measures
the shipped CLI end-to-end (`snp --coordinator`), not a toy step.

Usage:  python scripts/weak_scaling_proxy.py [--reads-per-proc 24] [--n 1 2 4]
Prints one line per N and a final efficiency summary (markdown-ready).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_world(n, data, ref, base_env, batch_reads, port):
    out_vcf = os.path.join(data, f"out_n{n}.vcf")
    argv = ["snp", ref, data, "-o", out_vcf, "--backend", "scan",
            "--batch-reads", str(batch_reads)]
    if n == 1:
        cmds = [[sys.executable, "-m", "nadavca_tpu.cli"] + argv]
    else:
        cmds = [[sys.executable, "-m", "nadavca_tpu.cli"] + argv +
                ["--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(n), "--process-id", str(i)]
                for i in range(n)]
    t0 = time.time()
    procs = [subprocess.Popen(c, env=base_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [p.communicate(timeout=900) for p in procs]
    wall = time.time() - t0
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError(f"N={n} failed: {outs}")
    # process 0's metrics line carries the batch-loop gauge
    m = re.search(r"\[metrics\] (\{.*\})", outs[0][1])
    gauges = json.loads(m.group(1))["gauges"] if m else {}
    return wall, gauges.get("reads_per_s", 0.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads-per-proc", type=int, default=24)
    ap.add_argument("--read-length", type=int, default=400)
    ap.add_argument("--batch-reads", type=int, default=8)
    ap.add_argument("--n", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()

    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["PYTHONPATH"] = REPO
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"

    results = {}
    port = 9451
    with tempfile.TemporaryDirectory() as tmp:
        for n in args.n:
            # fresh dataset per N so every process holds the same read count
            data = os.path.join(tmp, f"d{n}")
            subprocess.run(
                [sys.executable, "-m", "nadavca_tpu.cli", "simulate", "-o",
                 data, "--reads", str(args.reads_per_proc * n),
                 "--files", str(n), "--read-length", str(args.read_length),
                 "--genome-length", "2500", "--snps", "2", "--seed", "9"],
                env=base_env, check=True, capture_output=True)
            ref = os.path.join(data, "reference.fasta")
            wall, rate = run_world(n, data, ref, base_env, args.batch_reads,
                                   port)
            port += 2
            results[n] = (wall, rate)
            print(f"N={n}: wall {wall:.1f}s, per-process loop rate "
                  f"{rate:.2f} reads/s", flush=True)
    base = results[args.n[0]][1]
    print("\n| processes | per-process reads/s | weak-scaling efficiency |")
    print("|---|---|---|")
    for n in args.n:
        eff = results[n][1] / base if base > 0 else 0.0
        print(f"| {n} | {results[n][1]:.2f} | {eff:.2f} |")
    print("\nNOTE: CPU-process proxy on a 2-core host — N>2 oversubscribes "
          "the host, so efficiencies there bound below the real interconnect; "
          "the number that matters is N=2 vs N=1.")


if __name__ == "__main__":
    main()
