"""Import hygiene of the PyTorch port: ``repro_torch`` and ``chip_smoke.py``
import no JAX and nothing of the JAX package ``repro``."""
import ast
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts), path


def _imported_names(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


TRAINING_MODULES = ("repro_torch.data.protein", "repro_torch.train.optim",
                    "repro_torch.train.trainstep", "repro_torch.train.trainer",
                    "repro_torch.launch.train", "repro_torch.data.ingest",
                    "repro_torch.data.bucketing", "repro_torch.data.pipeline",
                    "repro_torch.data.loader", "repro_torch.train.checkpoint")


LM_MODULES = ("repro_torch.models", "repro_torch.models.lmconfig",
              "repro_torch.models.dense", "repro_torch.configs",
              "repro_torch.configs.glm4_9b", "repro_torch.nn.attention",
              "repro_torch.nn.rope", "repro_torch.kernels.flash_attention",
              "repro_torch.serve.engine", "repro_torch.serve.steps",
              "repro_torch.models.moe", "repro_torch.models.ssm",
              "repro_torch.models.hybrid",
              "repro_torch.configs.qwen2_moe_a2_7b",
              "repro_torch.configs.mamba2_2_7b",
              "repro_torch.configs.zamba2_7b",
              "repro_torch.models.whisper", "repro_torch.models.vlm",
              "repro_torch.data.tokens",
              "repro_torch.configs.whisper_medium",
              "repro_torch.configs.internvl2_26b",
              "repro_torch.nn.partition")


PARALLEL_MODULES = ("repro_torch.parallel", "repro_torch.parallel.plan",
                    "repro_torch.parallel.branch", "repro_torch.parallel.dap",
                    "repro_torch.parallel.grad_sync",
                    "repro_torch.parallel.mesh_utils",
                    "repro_torch.parallel.collectives",
                    "repro_torch.parallel.ranks",
                    "repro_torch.parallel.fsdp",
                    "repro_torch.parallel.tensor", "repro_torch.analysis",
                    "repro_torch.analysis.roofline")


SERVING_MODULES = ("repro_torch.serve.fold_engine",
                   "repro_torch.serve.fold_steps",
                   "repro_torch.serve.scheduler",
                   "repro_torch.serve.result_cache",
                   "repro_torch.data.featurize", "repro_torch.launch.serve")


OBS_MODULES = ("repro_torch.obs", "repro_torch.obs.registry",
               "repro_torch.obs.sinks", "repro_torch.obs.tracing",
               "repro_torch.obs.attribution", "repro_torch.analysis.roofline")


ANALYSIS_MODULES = ("repro_torch.analysis.lint", "repro_torch.analysis.overlap",
                    "repro_torch.analysis.static",
                    "repro_torch.analysis.static.core",
                    "repro_torch.analysis.static.op_walk",
                    "repro_torch.analysis.static.program",
                    "repro_torch.analysis.static.passes",
                    "repro_torch.analysis.static.passes.materialization",
                    "repro_torch.analysis.static.passes.collectives",
                    "repro_torch.analysis.static.passes.precision",
                    "repro_torch.analysis.static.passes.rng",
                    "repro_torch.analysis.static.passes.retrace",
                    "repro_torch.trace_hooks")


def test_no_jax_or_reference_imports_in_source():
    files = [p for _, p in _modules()] + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    assert set(TRAINING_MODULES) <= {m for m, _ in _modules()}
    assert set(LM_MODULES) <= {m for m, _ in _modules()}
    assert set(PARALLEL_MODULES) <= {m for m, _ in _modules()}
    assert set(SERVING_MODULES) <= {m for m, _ in _modules()}
    assert set(OBS_MODULES) <= {m for m, _ in _modules()}
    assert set(ANALYSIS_MODULES) <= {m for m, _ in _modules()}
    bad = []
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "repro"):
                bad.append(f"{path.relative_to(ROOT)}: {name}")
    assert not bad, bad


def test_every_module_imports_with_jax_blocked():
    names = [m for m, _ in _modules()]
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[blocked] = None\n"
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'repro.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
