"""The port stands alone: no module of src/repro_torch, and neither
chip_smoke.py nor chip_compare.py, imports jax, the JAX package or
msgpack; everything imports with them blocked; every name that the
reference's package ``__init__`` files export is importable from the
port's counterpart, and the quantizer family's entry points are there
under the reference's names; and an entry point left to its default
device (CUDA) raises when there is no CUDA instead of falling back to the
CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                     ROOT / "chip_compare.py"]


def _modules():
    out = []
    for f in sorted(PORT.rglob("*.py")):
        rel = f.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), (path, name)


def test_everything_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke, chip_compare\n"
        "assert not any(m.startswith(('jax', 'repro.')) for m in sys.modules"
        " if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# the quantizer family's entry points, under the reference's names where the
# reference has them (``cohort_tap_rows_lowrank``, ``basis_seeds``, ...)
FAMILY_NAMES = [
    ("repro_torch.common.prng", "permutation"),
    ("repro_torch.common.prng", "choice"),
    ("repro_torch.kernels.qsgd", "basis_seeds"),
    ("repro_torch.kernels.qsgd", "sketch_signs"),
    ("repro_torch.kernels.qsgd", "sketch_project"),
    ("repro_torch.kernels.qsgd", "sketch_expand"),
    ("repro_torch.kernels.ops", "lowrank_window_delta"),
    ("repro_torch.kernels.ops", "qsgd_dequantize_stack"),
    ("repro_torch.kernels.taps", "lowrank_upload_taps"),
    ("repro_torch.obs.taps", "cohort_tap_rows_lowrank"),
    ("repro_torch.core.quantizers", "packed_lowrank_payload"),
    ("repro_torch.core.quantizers", "lowrank_project_flat2d"),
    ("repro_torch.core.quantizers", "lowrank_expand_flat2d"),
    ("repro_torch.core.quantizers", "sparse_payload"),
    ("repro_torch.core.protocol", "encode_message_flat"),
]


# the population engine's, under the reference's names
POPULATION_NAMES = [
    ("repro_torch.kernels.population", "scenario_draws"),
    ("repro_torch.kernels.population", "run_seeds"),
    ("repro_torch.kernels.population", "init_population"),
    ("repro_torch.kernels.population", "wheel_shape"),
    ("repro_torch.kernels.population", "pack_step_out"),
    ("repro_torch.kernels.population", "PopStepOut"),
    ("repro_torch.kernels.population", "CompiledScenario"),
    ("repro_torch.kernels.ops", "population_advance"),
    ("repro_torch.core.staleness", "StalenessMonitor"),
    ("repro_torch.sim.population", "compile_scenario"),
    ("repro_torch.sim", "PopulationAsyncFLSimulator"),
    ("repro_torch.sim", "PopulationEngine"),
    ("repro_torch.obs.taps", "named_population_counts"),
]


@pytest.mark.parametrize("module,name", POPULATION_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_population_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


@pytest.mark.parametrize("module,name", FAMILY_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_quantizer_family_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


def test_default_device_raises_without_cuda(monkeypatch, tmp_path):
    from repro_torch.common.device import resolve_device
    from repro_torch.convert import params_from_jax
    from repro_torch.core import QAFeL, QAFeLConfig
    from repro_torch.examples import (cohort_scenarios, federated_celeba,
                                      quickstart)
    from repro_torch.kernels.population import init_population
    from repro_torch.models.cnn import init_cnn
    from repro_torch.sim import PopulationEngine
    from repro_torch.sim.cohort import auto_member_chunk

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        QAFeL(QAFeLConfig(), quickstart.loss_fn, {"w": torch.zeros(8)})
    for cq, sq in (("lowrank4g32", "top_k0.1"), ("rand_k0.1", "lowrank")):
        with pytest.raises(RuntimeError, match="CUDA"):
            QAFeL(QAFeLConfig(client_quantizer=cq, server_quantizer=sq),
                  quickstart.loss_fn, {"w": torch.zeros(8)})
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.run(uploads=1, verbose=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        federated_celeba.main(["--uploads", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [0.0, 1.0]})
    trace = tmp_path / "trace.jsonl"
    with pytest.raises(RuntimeError, match="CUDA"):
        cohort_scenarios.main(["--model", "quad", "--uploads", "1",
                               "--trace", str(trace)])
    assert not trace.exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_cnn(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        PopulationEngine("identity", concurrency=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_population(16, 2, 8, 64)
    with pytest.raises(RuntimeError, match="CUDA"):
        cohort_scenarios.main(["--model", "quad", "--uploads", "1",
                               "--engine", "population"])
    with pytest.raises(RuntimeError, match="CUDA"):
        auto_member_chunk(32, 1000)
    assert auto_member_chunk(32, 1000, free_bytes=1 << 40) is None
    assert resolve_device("cpu") == torch.device("cpu")
    assert init_cnn(0, device="cpu")["head"]["w"].device.type == "cpu"


# the dense decoder and its round, under the reference's names
LLM_NAMES = [
    ("repro_torch.models.config", "ModelConfig"),
    ("repro_torch.configs", "get_config"),
    ("repro_torch.configs", "get_reduced"),
    ("repro_torch.configs", "list_archs"),
    ("repro_torch.models.layers", "rms_norm"),
    ("repro_torch.models.layers", "apply_rope"),
    ("repro_torch.models.layers", "rope_frequencies"),
    ("repro_torch.models.layers", "gated_mlp"),
    ("repro_torch.models.layers", "init_gated_mlp"),
    ("repro_torch.models.layers", "softcap"),
    ("repro_torch.models.layers", "embed_init"),
    ("repro_torch.models.attention", "init_attention"),
    ("repro_torch.models.attention", "blockwise_attention"),
    ("repro_torch.models.attention", "attention_train"),
    ("repro_torch.models.transformer", "init_params"),
    ("repro_torch.models.transformer", "forward"),
    ("repro_torch.models.transformer", "logits_fn"),
    ("repro_torch.models.transformer", "loss_fn"),
    ("repro_torch.data.synthetic", "synthetic_lm_batch"),
    ("repro_torch.data.synthetic", "synthetic_batch_for_config"),
    ("repro_torch.core.qafel", "local_sgd"),
    ("repro_torch.distributed.steps", "RoundState"),
    ("repro_torch.distributed.steps", "init_round_state"),
    ("repro_torch.distributed.steps", "make_qafel_round"),
    ("repro_torch.convert", "round_state_from_jax"),
    ("repro_torch.examples.federated_llm", "main"),
]


# the streamed encode and uplink and the full-depth round's pieces, under
# the reference's names where it has them
STREAM_NAMES = [
    ("repro_torch.kernels.ops", "qsgd_quantize_chunk"),
    ("repro_torch.kernels.ops", "qsgd_quantize_rows"),
    ("repro_torch.kernels.ops", "qsgd_encode_chunks"),
    ("repro_torch.kernels.server_update", "server_update_"),
    ("repro_torch.kernels.ref", "server_update_"),
    ("repro_torch.core.quantizers", "qsgd_encode_rows"),
    ("repro_torch.core.quantizers", "qsgd_encode_flat2d"),
    ("repro_torch.core.protocol", "packed_qsgd_chunk_payload"),
    ("repro_torch.core.protocol", "frame_chunk_messages"),
    ("repro_torch.core.buffer", "UpdateBuffer"),
    ("repro_torch.core.qafel", "DeltaRows"),
    ("repro_torch.core.qafel", "client_update"),
    ("repro_torch.distributed.steps", "accumulate"),
    ("repro_torch.distributed.steps", "server_half"),
]


@pytest.mark.parametrize("module,name", STREAM_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_stream_slice_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


def test_stream_methods_exist():
    from repro_torch.core import QAFeL
    from repro_torch.core.buffer import UpdateBuffer
    from repro_torch.core.protocol import TrafficMeter
    from repro_torch.distributed.steps import RoundState
    for cls, name in ((QAFeL, "run_client_stream"),
                      (UpdateBuffer, "add_encoded_chunks"),
                      (UpdateBuffer, "assemble_chunks"),
                      (TrafficMeter, "record_stream"),
                      (RoundState, "from_trees"), (RoundState, "clone")):
        assert callable(getattr(cls, name)), (cls, name)


@pytest.mark.parametrize("module,name", LLM_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_llm_slice_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


def test_llm_entry_points_default_to_cuda(monkeypatch):
    from repro_torch import configs
    from repro_torch.distributed.steps import init_round_state
    from repro_torch.examples import federated_llm
    from repro_torch.models.transformer import init_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get_reduced("gemma2-2b")
    for fn in (lambda: init_params(cfg), lambda: init_round_state(cfg),
               lambda: federated_llm.main(["--rounds", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn()


# serving and the round's taps, under the reference's names where it has
# them
SERVE_NAMES = [
    ("repro_torch.models.attention", "init_attn_cache"),
    ("repro_torch.models.attention", "prefill_into_cache"),
    ("repro_torch.models.attention", "attention_decode"),
    ("repro_torch.models.transformer", "prefill"),
    ("repro_torch.models.transformer", "init_cache"),
    ("repro_torch.models.transformer", "abstract_cache"),
    ("repro_torch.models.transformer", "decode_step"),
    ("repro_torch.distributed.steps", "make_prefill_step"),
    ("repro_torch.distributed.steps", "make_decode_step"),
    ("repro_torch.convert", "cache_from_jax"),
    ("repro_torch.launch.serve", "main"),
    ("repro_torch.launch.serve", "serve"),
    ("repro_torch.examples.serve_model", "main"),
    ("repro_torch.kernels.taps", "round_taps"),
    ("repro_torch.kernels.ref", "round_taps"),
    ("repro_torch.kernels.ref", "round_taps_finish"),
    ("repro_torch.kernels.ref", "dequantize_taps"),
]


@pytest.mark.parametrize("module,name", SERVE_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_serve_slice_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


@pytest.mark.parametrize("module", ["repro_torch.launch",
                                    "repro_torch.launch.serve",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.shapes"])
def test_launch_imports_without_jax(module):
    """The launchers import, with jax and the JAX package blocked, and
    bring neither in."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro', 'msgpack'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "assert not any(m.startswith(('jax', 'repro.')) for m in "
            "sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


# every name the reference's package __init__ files export
REFERENCE_PACKAGES = ["core", "common", "models", "data", "distributed",
                      "sim", "optim", "checkpoint"]


def _exported(package: str):
    init = ROOT / "src" / "repro" / package / "__init__.py"
    tree = ast.parse(init.read_text(), filename=str(init))
    return sorted(alias.asname or alias.name for node in ast.walk(tree)
                  if isinstance(node, ast.ImportFrom)
                  for alias in node.names)


@pytest.mark.parametrize("package", REFERENCE_PACKAGES)
def test_reference_package_names_are_exported(package):
    import importlib
    names = _exported(package)
    assert names, package
    port = importlib.import_module(f"repro_torch.{package}")
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing, (package, missing)


# the launcher, checkpoints, optimizers and the names of this slice
TRAIN_NAMES = [
    ("repro_torch.launch.train", "main"),
    ("repro_torch.launch.train", "run"),
    ("repro_torch.launch.train", "round_key"),
    ("repro_torch.checkpoint.ckpt", "save_checkpoint"),
    ("repro_torch.checkpoint.ckpt", "load_checkpoint"),
    ("repro_torch.checkpoint.ckpt", "latest_step"),
    ("repro_torch.checkpoint.mpack", "pack"),
    ("repro_torch.checkpoint.mpack", "unpack"),
    ("repro_torch.optim.optimizers", "make_optimizer"),
    ("repro_torch.models.transformer", "abstract_params"),
    ("repro_torch.distributed.steps", "abstract_round_state"),
    ("repro_torch.distributed.steps", "upload"),
    ("repro_torch.distributed.steps", "accumulate_upload"),
    ("repro_torch.core.protocol", "encode_message"),
    ("repro_torch.core.protocol", "decode_message"),
    ("repro_torch.core.staleness", "staleness_weight"),
]


@pytest.mark.parametrize("module,name", TRAIN_NAMES,
                         ids=lambda v: v.split(".")[-1])
def test_train_slice_entry_points(module, name):
    import importlib
    assert callable(getattr(importlib.import_module(module), name))


def test_celeba_cnn_config_module():
    from repro_torch.configs import celeba_cnn
    assert celeba_cnn.CONFIG is None and celeba_cnn.REDUCED is None
    assert celeba_cnn.BUFFER_K == 10
