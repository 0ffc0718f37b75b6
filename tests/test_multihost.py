"""Multi-host process-group validation inside pytest (SURVEY.md §4 item 4).

Spawns scripts/multihost_demo.py: 2 local jax.distributed processes (4 CPU
devices each) run the unified sharded step on their own half of a read set;
process 0 asserts the DCN-merged accumulators exactly equal a single-process
reference, and reports the per-batch collective traffic — the config-5
scaling proxy available without pod hardware.
"""

import os
import subprocess
import sys

import pytest

SCRIPT = os.path.join(os.path.dirname(__file__), "..", "scripts",
                      "multihost_demo.py")


def test_multihost_merge_matches_single_process(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["MULTIHOST_DEMO_REF"] = str(tmp_path / "ref.npz")
    env["MULTIHOST_DEMO_PORT"] = "9417"
    res = subprocess.run(
        [sys.executable, SCRIPT], env=env, capture_output=True, text=True,
        timeout=540,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "MULTIHOST_OK" in res.stdout, res.stdout + res.stderr
    assert "merged accumulators == single-process reference" in res.stdout


def _run_cli(argv, env, timeout=540):
    return subprocess.run([sys.executable, "-m", "nadavca_tpu.cli"] + argv,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def test_multihost_cli_vcf_identical(tmp_path):
    """`nadavca-tpu snp --coordinator ...` with 2 processes must produce the
    byte-identical VCF of a single-process run (VERDICT r2 task 5: config 5
    reachable from the shipped tool)."""
    repo = os.path.join(os.path.dirname(__file__), "..")
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["PYTHONPATH"] = repo
    data = tmp_path / "data"
    sim = _run_cli(["simulate", "-o", str(data), "--reads", "24",
                    "--read-length", "400", "--genome-length", "2500",
                    "--snps", "3", "--seed", "9", "--files", "4"], base_env)
    assert sim.returncode == 0, sim.stdout + sim.stderr

    ref_vcf = tmp_path / "ref.vcf"
    env1 = dict(base_env)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    r = _run_cli(["snp", str(data / "reference.fasta"), str(data),
                  "-o", str(ref_vcf), "--backend", "scan",
                  "--batch-reads", "8", "--devices", "all"], env1)
    assert r.returncode == 0, r.stdout + r.stderr

    # two processes, one CPU device each, DCN-style merge via the CLI
    out_vcf = tmp_path / "mh.vcf"
    env2 = dict(base_env)
    env2["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nadavca_tpu.cli", "snp",
             str(data / "reference.fasta"), str(data), "-o", str(out_vcf),
             "--backend", "scan", "--batch-reads", "8",
             "--coordinator", "127.0.0.1:9431",
             "--num-processes", "2", "--process-id", str(i)],
            env=env2, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    ref_body = [l for l in ref_vcf.read_text().splitlines()
                if not l.startswith("##")]
    mh_body = [l for l in out_vcf.read_text().splitlines()
               if not l.startswith("##")]
    assert mh_body == ref_body, (mh_body, ref_body)
    # at least one real call so the equality is not vacuous
    assert sum(1 for l in mh_body if not l.startswith("#")) >= 1


def test_multihost_cli_scan_uneven_n3(tmp_path):
    """Production configuration through the CLI multihost loop: the scan
    backend + genome-sharded accumulators, 3 processes with UNEVEN shards —
    the all-padding-batch path runs for real — asserting the
    byte-identical VCF of a single-process run."""
    repo = os.path.join(os.path.dirname(__file__), "..")
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["PYTHONPATH"] = repo
    data = tmp_path / "data"
    # 5 files over 3 processes -> shards of 2/2/1 files; batch-reads 8 over
    # 10 reads per shard-of-2 vs 5 reads on the short shard -> the short
    # process contributes all-padding batches in the agreed final rounds
    sim = _run_cli(["simulate", "-o", str(data), "--reads", "25",
                    "--read-length", "400", "--genome-length", "2500",
                    "--snps", "3", "--seed", "11", "--files", "5"], base_env)
    assert sim.returncode == 0, sim.stdout + sim.stderr

    ref_vcf = tmp_path / "ref.vcf"
    env1 = dict(base_env)
    env1["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    r = _run_cli(["snp", str(data / "reference.fasta"), str(data),
                  "-o", str(ref_vcf), "--backend", "scan",
                  "--batch-reads", "8", "--genome-sharded", "off"], env1)
    assert r.returncode == 0, r.stdout + r.stderr

    out_vcf = tmp_path / "mh.vcf"
    env2 = dict(base_env)
    env2["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nadavca_tpu.cli", "snp",
             str(data / "reference.fasta"), str(data), "-o", str(out_vcf),
             "--backend", "scan", "--batch-reads", "8",
             "--genome-sharded", "on",
             "--coordinator", "127.0.0.1:9437",
             "--num-processes", "3", "--process-id", str(i)],
            env=env2, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(3)
    ]
    outs = [p.communicate(timeout=540) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    ref_body = [l for l in ref_vcf.read_text().splitlines()
                if not l.startswith("##")]
    mh_body = [l for l in out_vcf.read_text().splitlines()
               if not l.startswith("##")]
    assert mh_body == ref_body, (mh_body, ref_body)
    assert sum(1 for l in mh_body if not l.startswith("#")) >= 1


def test_multihost_cli_checkpoint_resume(tmp_path):
    """Multi-host checkpoint/resume (VERDICT r3 task 4): a 2-process run
    writes per-process manifest shards + process-0 accumulators; rerunning
    with the same checkpoint skips every read and reproduces the VCF."""
    repo = os.path.join(os.path.dirname(__file__), "..")
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["PYTHONPATH"] = repo
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    data = tmp_path / "data"
    sim = _run_cli(["simulate", "-o", str(data), "--reads", "16",
                    "--read-length", "300", "--genome-length", "1500",
                    "--snps", "2", "--seed", "13", "--files", "4"], base_env)
    assert sim.returncode == 0, sim.stdout + sim.stderr
    ckpt = tmp_path / "state.npz"

    def run_pair(out_name, port):
        out_vcf = tmp_path / out_name
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "nadavca_tpu.cli", "snp",
                 str(data / "reference.fasta"), str(data), "-o",
                 str(out_vcf), "--backend", "scan", "--batch-reads", "4",
                 "--checkpoint", str(ckpt), "--checkpoint-every", "1",
                 "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", "2", "--process-id", str(i)],
                env=base_env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for i in range(2)
        ]
        outs = [p.communicate(timeout=540) for p in procs]
        assert all(p.returncode == 0 for p in procs), outs
        return out_vcf, outs

    v1, _ = run_pair("run1.vcf", 9441)
    assert ckpt.exists() and (tmp_path / "state.npz.p1").exists()
    v2, outs2 = run_pair("run2.vcf", 9443)
    # every read skipped on resume, VCF reproduced from restored accumulators
    assert "resuming:" in outs2[0][1] + outs2[1][1], outs2
    body = lambda p: [l for l in p.read_text().splitlines()
                      if not l.startswith("##")]
    assert body(v2) == body(v1)
    assert sum(1 for l in body(v1) if not l.startswith("#")) >= 1


def test_multihost_cli_mixed_lengths_vcf_identical(tmp_path):
    """Mixed-length N=2 parity (VERDICT r4 task 3): short reads run the
    narrow band and long reads (above adaptive_band_threshold) the wide band
    IN THE SAME RUN — the round-4 design picked one global band from the
    shard max, so this byte-identity was impossible. The streamed per-bucket
    shape agreement keys the band per bucket like the single-host path."""
    repo = os.path.join(os.path.dirname(__file__), "..")
    base_env = {k: v for k, v in os.environ.items()
                if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["PYTHONPATH"] = repo
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    data = tmp_path / "data"
    # 300-base reads ~3k samples (narrow band); 2200-base reads ~22k samples
    # > adaptive_band_threshold=16384 (band_width_long)
    sim = _run_cli(["simulate", "-o", str(data), "--reads", "14",
                    "--read-length", "300,2200", "--genome-length", "3000",
                    "--snps", "3", "--seed", "17", "--files", "4"], base_env)
    assert sim.returncode == 0, sim.stdout + sim.stderr

    ref_vcf = tmp_path / "ref.vcf"
    r = _run_cli(["snp", str(data / "reference.fasta"), str(data),
                  "-o", str(ref_vcf), "--backend", "scan",
                  "--batch-reads", "4"], base_env, timeout=900)
    assert r.returncode == 0, r.stdout + r.stderr

    out_vcf = tmp_path / "mh.vcf"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "nadavca_tpu.cli", "snp",
             str(data / "reference.fasta"), str(data), "-o", str(out_vcf),
             "--backend", "scan", "--batch-reads", "4",
             "--coordinator", "127.0.0.1:9447",
             "--num-processes", "2", "--process-id", str(i)],
            env=base_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=900) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    ref_body = [l for l in ref_vcf.read_text().splitlines()
                if not l.startswith("##")]
    mh_body = [l for l in out_vcf.read_text().splitlines()
               if not l.startswith("##")]
    assert mh_body == ref_body, (mh_body, ref_body)
    assert sum(1 for l in mh_body if not l.startswith("#")) >= 1


def _spawn_mh_pair(data, out_vcf, ckpt, port, env, extra_env=None):
    e = dict(env)
    e.update(extra_env or {})
    return [
        subprocess.Popen(
            [sys.executable, "-m", "nadavca_tpu.cli", "snp",
             str(data / "reference.fasta"), str(data), "-o", str(out_vcf),
             "--backend", "scan", "--batch-reads", "4",
             "--checkpoint", str(ckpt), "--checkpoint-every", "1",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i)],
            env=e, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]


def _reap(procs, timeout=120):
    """Wait for the pair; kill stragglers by exact handle (a dead peer
    leaves the survivor blocked in a collective)."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    return outs


def test_multihost_checkpoint_crash_consistency(tmp_path):
    """VERDICT r4 task 4: prove the manifests→barrier→accumulators protocol's
    crash claim. Case A (clean save, then death): process 0 dies right after
    a complete round-2 save — resume must validate, skip the merged reads,
    and reproduce the reference VCF. Case B (torn save): process 0 dies
    after the barrier but BEFORE writing the accumulators — the shard batch
    counters disagree on disk, and every process must reject resume with the
    designed error."""
    repo = os.path.join(os.path.dirname(__file__), "..")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = repo
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    data = tmp_path / "data"
    sim = _run_cli(["simulate", "-o", str(data), "--reads", "24",
                    "--read-length", "300", "--genome-length", "1500",
                    "--snps", "2", "--seed", "19", "--files", "4"], env)
    assert sim.returncode == 0, sim.stdout + sim.stderr

    ref_vcf = tmp_path / "ref.vcf"
    r = _run_cli(["snp", str(data / "reference.fasta"), str(data),
                  "-o", str(ref_vcf), "--backend", "scan",
                  "--batch-reads", "4"], env)
    assert r.returncode == 0, r.stdout + r.stderr
    body = lambda p: [l for l in p.read_text().splitlines()
                      if not l.startswith("##")]
    assert sum(1 for l in body(ref_vcf) if not l.startswith("#")) >= 1

    # --- Case A: death immediately after a COMPLETE save ---
    ckpt = tmp_path / "a.npz"
    procs = _spawn_mh_pair(data, tmp_path / "a_crash.vcf", ckpt, 9449, env,
                           {"NADAVCA_TPU_CRASH_POINT": "post_save@0:2"})
    outs = _reap(procs)
    assert procs[0].returncode == 57, outs  # the injected kill fired
    assert ckpt.exists() and (tmp_path / "a.npz.p1").exists()
    # resume with a fresh pair: validation passes, merged reads skipped
    out_a = tmp_path / "a.vcf"
    procs = _spawn_mh_pair(data, out_a, ckpt, 9451, env)
    outs = _reap(procs, timeout=540)
    assert all(p.returncode == 0 for p in procs), outs
    assert "resuming:" in outs[0][1] + outs[1][1], outs
    assert body(out_a) == body(ref_vcf)

    # --- Case B: death AFTER the manifest barrier, BEFORE the accumulator
    # write — the torn state the protocol's ordering is designed around ---
    ckpt = tmp_path / "b.npz"
    procs = _spawn_mh_pair(data, tmp_path / "b_crash.vcf", ckpt, 9453, env,
                           {"NADAVCA_TPU_CRASH_POINT": "pre_acc@0:2"})
    outs = _reap(procs)
    assert procs[0].returncode == 57, outs
    # disk now holds accumulators@1 but process-1 manifest@2: resume must be
    # REFUSED by every process with the designed error
    procs = _spawn_mh_pair(data, tmp_path / "b.vcf", ckpt, 9455, env)
    outs = _reap(procs, timeout=540)
    assert all(p.returncode != 0 for p in procs), outs
    assert all("died mid-save" in o[1] for o in outs), outs
