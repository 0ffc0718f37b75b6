"""Utils coverage: metrics, profiling timers, compile cache idempotence."""

import json

import pytest

from nadavca_tpu.utils.cache import enable_compile_cache
from nadavca_tpu.utils.metrics import Metrics
from nadavca_tpu.utils.profiling import StageTimer, trace


def test_metrics_counters_and_jsonl(tmp_path):
    m = Metrics()
    m.count("reads", 3)
    m.count("reads", 2)
    m.gauge("rate", 1.234)
    snap = m.snapshot()
    assert snap["counters"]["reads"] == 5
    assert snap["gauges"]["rate"] == 1.234
    p = str(tmp_path / "m.jsonl")
    m.write_jsonl(p)
    m.write_jsonl(p)
    lines = open(p).read().splitlines()
    assert len(lines) == 2
    assert json.loads(lines[0])["counters"]["reads"] == 5


def test_stage_timer_feeds_metrics():
    m = Metrics()
    st = StageTimer(m)
    with st.stage("ingest"):
        pass
    with st.stage("ingest"):
        pass
    assert "ingest" in st.totals
    assert "stage_ingest_s" in m.gauges


def test_trace_none_is_noop():
    with trace(None):
        x = 1 + 1
    assert x == 2


def test_enable_compile_cache_idempotent():
    enable_compile_cache()
    enable_compile_cache()  # second call must be a no-op


def test_compile_cache_dir_honours_env(monkeypatch, tmp_path):
    from nadavca_tpu.utils.cache import compile_cache_dir

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_compile_cache_default_is_fixed_inside_checkout(monkeypatch):
    import os

    from nadavca_tpu.utils.cache import compile_cache_dir
    from nadavca_tpu.utils.native_build import REPO_ROOT

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache_dir()
    assert path == os.path.join(REPO_ROOT, ".cache", "xla")
    assert compile_cache_dir() == path  # no temp name, pid or time in it
    with open(os.path.join(REPO_ROOT, ".gitignore")) as f:
        assert ".cache/" in f.read().split()


@pytest.mark.parametrize("module", ["nadavca_tpu", "nadavca_tpu.cli"])
def test_imports_without_yaml(module):
    """Only --configuration needs yaml; the main path must import without."""
    import subprocess
    import sys

    code = (f"import sys; sys.modules['yaml'] = None; import {module}; "
            "from nadavca_tpu.config import AlignConfig; "
            "AlignConfig()\n"
            "try:\n    AlignConfig.from_yaml('x.yaml')\n"
            "except ImportError:\n    print('yaml-only-on-demand')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env={**__import__("os").environ,
                                       "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    assert "yaml-only-on-demand" in r.stdout


@pytest.mark.parametrize("visible,count", [("0,1,2,3", 4), ("2", 1), ("", 0)])
def test_local_gpu_count_reads_visible_devices(monkeypatch, visible, count):
    from nadavca_tpu.parallel import distributed

    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    assert distributed.local_gpu_count() == count


def _init_kwargs(monkeypatch, n_gpu, coordinator, n_proc, pids):
    import jax

    from nadavca_tpu.parallel import distributed

    seen = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: seen.append(kw))
    monkeypatch.setattr(distributed, "local_gpu_count", lambda: n_gpu)
    for pid in pids:
        distributed.initialize_distributed(coordinator, n_proc, pid)
    return seen


def test_each_process_binds_one_local_gpu(monkeypatch):
    """With a loopback coordinator every process shares this host: process
    p opens local card p mod n, so no two reserve memory on one card."""
    seen = _init_kwargs(monkeypatch, 4, "localhost:1", 6, range(6))
    assert [kw["local_device_ids"] for kw in seen] == [[0], [1], [2], [3],
                                                       [0], [1]]
    assert all(kw["coordinator_address"] == "localhost:1" and
               kw["num_processes"] == 6 for kw in seen)
    seen = _init_kwargs(monkeypatch, 0, "localhost:1", 2, [1])
    assert "local_device_ids" not in seen[-1]  # CPU hosts: all devices


@pytest.mark.parametrize("coordinator,n_proc,bound", [
    ("127.0.0.1:9", 2, True),
    ("[::1]:9", 2, True),
    ("localhost:9", 1, False),      # one process keeps every card
    ("10.0.0.5:9", 2, False),       # network coordinator: one per host
    ("node0.cluster:9", 4, False),
])
def test_gpu_binding_follows_the_coordinator(monkeypatch, coordinator,
                                             n_proc, bound):
    """Only a loopback group of several processes is bound to one card each;
    a network coordinator keeps the one-process-per-host layout, in which
    each process opens all of its host's cards."""
    seen = _init_kwargs(monkeypatch, 4, coordinator, n_proc, [1])
    assert (seen[0].get("local_device_ids") == [1]) is bound
    assert ("local_device_ids" in seen[0]) is bound
