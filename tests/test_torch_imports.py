"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the JAX package, its entry points want the GPU unless
the caller asks for the CPU, and its serving CLI answers requests."""
import functools
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]

_BLOCKED_IMPORTS = r"""
import importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib", "repro"):
            raise ImportError(f"repro_torch imported {name}")
        return None

sys.meta_path.insert(0, Refuse())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    __import__(name)
import chip_smoke
assert not [m for m in sys.modules if m.split(".")[0] in ("jax", "repro")]
print(len(names), "modules:", " ".join(names))
"""


def _env():
    return {**os.environ,
            "PYTHONPATH": os.pathsep.join([str(REPO / "src"), str(REPO)])}


def test_every_module_imports_with_jax_and_repro_refused():
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS],
                         env=_env(), cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 63
    names = out.stdout.split(":", 1)[1].split()
    for name in ("repro_torch.serving.paging", "repro_torch.serving.engine",
                 "repro_torch.kernels.decode_attention",
                 "repro_torch.kernels.ops", "repro_torch.models.moe",
                 "repro_torch.configs.mixtral_8x7b",
                 "repro_torch.kernels.rwkv6", "repro_torch.models.rwkv6",
                 "repro_torch.configs.rwkv6_7b",
                 "repro_torch.kernels.flash_attention",
                 "repro_torch.kernels.attention_plain",
                 "repro_torch.configs.glm4_9b",
                 "repro_torch.core.solver", "repro_torch.core.baselines",
                 "repro_torch.core.simulator",
                 "repro_torch.launch.migration_demo",
                 "repro_torch.serving.workload",
                 "repro_torch.serving.async_runtime",
                 "repro_torch.configs.llama3_2_vision_11b",
                 "repro_torch.models.mamba2", "repro_torch.models.zamba2",
                 "repro_torch.configs.zamba2_2_7b",
                 "repro_torch.models.quantization",
                 "repro_torch.optim.adamw", "repro_torch.launch.steps",
                 "repro_torch.launch.train", "repro_torch.data.pipeline",
                 "repro_torch.checkpoint.checkpointer",
                 "repro_torch.launch.quickstart",
                 "repro_torch.launch.train_100m",
                 "repro_torch.models.partitioning",
                 "repro_torch.launch.mesh", "repro_torch.runtime.elastic",
                 "repro_torch.tree", "repro_torch.device",
                 "repro_torch.analysis", "repro_torch.analysis.lints",
                 "repro_torch.analysis.trace_audit",
                 "repro_torch.analysis.step_audit",
                 "repro_torch.analysis.__main__"):
        assert name in names


def test_no_source_line_imports_jax_or_repro():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b",
                         re.M)
    hits = [f"{p.relative_to(REPO)}: {m.group(0).strip()}"
            for p in SOURCES for m in pattern.finditer(p.read_text())]
    assert not hits


def test_engine_without_device_wants_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None serves on it")
    from repro_torch.configs import get_config
    from repro_torch.serving.engine import ServingEngine
    cfg = get_config("llama3-8b").with_overrides(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, n_slots=2, max_seq=16)


@pytest.mark.parametrize("entry", ["ShardedPrefetcher",
                                   "make_train_pipeline"])
def test_data_pipeline_wants_the_gpu_unless_asked_for_the_cpu(entry):
    """The prefetcher and the train pipeline place batches on the GPU when
    no device is named (raising without one), and on the CPU when
    asked."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None prefetches onto it")
    from repro_torch.configs import get_config
    from repro_torch.data import pipeline
    cfg = get_config("llama3-8b").with_overrides(vocab_size=50)
    shape = type("S", (), {"seq_len": 4, "global_batch": 2})()

    def make(**kw):
        if entry == "ShardedPrefetcher":
            return pipeline.ShardedPrefetcher(
                iter(pipeline.SyntheticLM(50, 4, 2)), **kw)
        return pipeline.make_train_pipeline(cfg, shape, **kw)[1]

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    it = make(device="cpu")
    assert next(it)["tokens"].device.type == "cpu"
    it.close()


@pytest.mark.parametrize("entry", ["build_model", "ServingEngine",
                                   "WaveServingEngine", "make_engine"])
def test_mixtral_entry_points_want_the_gpu_unless_asked_for_the_cpu(entry):
    """Each entry point of the Mixtral slice raises without a GPU when no
    device is named, and runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None serves on it")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine
    cfg = get_config("mixtral-8x7b").with_overrides(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50, n_experts=4, sliding_window=32)
    if entry == "build_model":
        make = build_model
    else:
        make = functools.partial(getattr(engine, entry), n_slots=2,
                                 max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)
    assert make(cfg, device="cpu") is not None


def test_serve_cli_answers_requests_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--requests", "3", "--tokens", "4",
         "--slots", "2", "--lam", "2", "--use-kernel", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "3 requests, 12 tokens" in out.stdout


def test_serve_cli_serves_paged_int8_kv_on_the_cpu():
    """``--paged --page-size 8 --kv-quant``: the paged int8 cache through
    the paged int8 kernel's plain version."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--requests", "3", "--tokens", "4",
         "--slots", "2", "--lam", "2", "--paged", "--page-size", "8",
         "--kv-quant", "--use-kernel", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "3 requests, 12 tokens" in out.stdout
    assert "prefill buckets [8]" in out.stdout


def test_serve_cli_serves_mixtral_past_its_window_on_the_cpu():
    """``--arch mixtral-8x7b --engine wave --use-kernel``: the reduced
    window (16) is below the served extent, so the ring cache wraps and
    decode runs the ring kernel's plain version; ``auto`` picks the same
    engine."""
    for engine in ("wave", "auto"):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--reduced", "--layers", "2", "--arch", "mixtral-8x7b",
             "--engine", engine, "--use-kernel", "--requests", "3",
             "--prompt-len", "12", "--tokens", "10", "--max-seq", "40",
             "--slots", "2", "--lam", "3", "--straggler", "0"],
            env=_env(), cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
        assert "WaveServingEngine" in out.stdout and "window 16" in out.stdout
        assert "3 requests, 30 tokens" in out.stdout


@pytest.mark.parametrize("entry", ["build_model", "WaveServingEngine",
                                   "make_engine"])
def test_rwkv6_entry_points_want_the_gpu_unless_asked_for_the_cpu(entry):
    """Each entry point of the RWKV-6 slice raises without a GPU when no
    device is named, and runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None serves on it")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine
    cfg = get_config("rwkv6-7b").with_overrides(
        n_layers=1, d_model=32, n_heads=2, d_ff=64, vocab_size=50)
    if entry == "build_model":
        make = build_model
    else:
        make = functools.partial(getattr(engine, entry), n_slots=2,
                                 max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)
    assert make(cfg, device="cpu") is not None


def test_serve_cli_serves_rwkv6_on_the_cpu():
    """``--arch rwkv6-7b --use-kernel``: ``auto`` picks the wave engine,
    and prefill and decode run the WKV6 kernel's plain version; the
    straggler's head plans are logged, not applied."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--arch", "rwkv6-7b", "--use-kernel",
         "--requests", "3", "--tokens", "6", "--slots", "2", "--lam", "2",
         "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "WaveServingEngine" in out.stdout
    assert "3 requests, 18 tokens" in out.stdout


@pytest.mark.parametrize("entry", ["build_model", "ServingEngine",
                                   "make_engine"])
def test_glm4_entry_points_want_the_gpu_unless_asked_for_the_cpu(entry):
    """Each entry point of the GLM-4 slice raises without a GPU when no
    device is named, and runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None serves on it")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine
    cfg = get_config("glm4-9b").with_overrides(
        n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50)
    if entry == "build_model":
        make = build_model
    else:
        make = functools.partial(getattr(engine, entry), n_slots=2,
                                 max_seq=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)
    assert make(cfg, device="cpu") is not None


def test_serve_cli_serves_glm4_on_the_cpu():
    """``--arch glm4-9b --use-kernel``: QKV bias and half-head RoPE on the
    continuous engine; each bucketed prefill runs the flash kernel's plain
    version, decode the flash-decode kernel's."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--arch", "glm4-9b", "--use-kernel",
         "--requests", "3", "--prompt-len", "20", "--mixed-lengths",
         "--tokens", "6", "--slots", "2", "--lam", "2", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ServingEngine" in out.stdout and "Wave" not in out.stdout
    assert "3 requests, 18 tokens" in out.stdout


@pytest.mark.parametrize("entry", ["build_model", "ServingEngine",
                                   "make_engine"])
def test_vlm_entry_points_want_the_gpu_unless_asked_for_the_cpu(entry):
    """Each entry point of the VLM slice raises without a GPU when no
    device is named, and runs on the CPU when asked to."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device=None serves on it")
    from repro_torch.configs import get_config
    from repro_torch.models.api import build_model
    from repro_torch.serving import engine
    cfg = get_config("llama-3.2-vision-11b").with_overrides(
        n_layers=5, d_model=32, n_heads=4, n_kv_heads=2, d_head=8, d_ff=64,
        vocab_size=50)
    if entry == "build_model":
        make = build_model
    else:
        make = functools.partial(getattr(engine, entry), n_slots=2,
                                 max_seq=16, img_tokens=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make(cfg)
    assert make(cfg, device="cpu") is not None


def test_serve_cli_serves_the_vlm_on_the_cpu():
    """``--arch llama-3.2-vision-11b --use-kernel``: one supergroup on the
    continuous engine, requests with images of 8, 4 and 0 rows in an
    8-row buffer; decode runs the resident kernel's plain version for the
    self and the cross layers."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "5", "--arch", "llama-3.2-vision-11b",
         "--use-kernel", "--requests", "3", "--tokens", "6", "--slots", "2",
         "--lam", "2", "--img-tokens", "8", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ServingEngine" in out.stdout and "Wave" not in out.stdout
    assert "3 requests, 18 tokens" in out.stdout


def test_serve_cli_serves_pipelined_bottleneck_search_on_the_cpu():
    """``--pipeline-k 2 --search bottleneck``: two slot groups decode in
    turn, and the bottleneck search plans the straggler's migrations."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--layers", "2", "--arch", "llama3-8b", "--requests",
         "6", "--tokens", "10", "--slots", "4", "--lam", "2",
         "--pipeline-k", "2", "--search", "bottleneck", "--use-kernel",
         "--mixed-lengths", "--straggler", "0"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "ServingEngine" in out.stdout
    assert "6 requests, 60 tokens" in out.stdout
    migrations = re.search(r"head-migrations=(\d+)", out.stdout)
    assert migrations and int(migrations.group(1)) > 0


def test_migration_demo_prints_the_six_policies():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.migration_demo"],
        env=_env(), cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rows = [line.split()[0] for line in out.stdout.splitlines()[1:7]]
    assert rows == ["resource-aware", "static", "galaxy", "edgeshard",
                    "greedy", "round-robin"]
    assert "speedups vs resource-aware" in out.stdout
