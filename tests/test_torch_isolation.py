"""The port stands alone: it imports neither JAX nor the JAX package, it
never runs on the CPU unless asked to, and ``chip_smoke.py`` fails
(printing no result) where there is no card or no package beside it."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "hcache_deepspeed_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "ml_dtypes", "pydantic",
             "transformers", "hcache_deepspeed_tpu"}
CHILD_ENV = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
             "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def _one_cpu_thread():
    """Tiny tensors: one intra-op thread, so parallel test workers do not
    oversubscribe the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_package_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, hcache_deepspeed_tpu_torch.inference, "
            "hcache_deepspeed_tpu_torch.ops, chip_smoke; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}); print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=CHILD_ENV, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch):
    from hcache_deepspeed_tpu_torch.inference import InferenceEngineV2
    from hcache_deepspeed_tpu_torch.models.llama import (llama_tiny,
                                                         random_params)
    from hcache_deepspeed_tpu_torch.platform import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama_tiny()
    params = random_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngineV2(cfg, params)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    script = REPO / "chip_smoke.py"
    cwd = REPO
    env = CHILD_ENV
    if alone:
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
        env = {**CHILD_ENV, "PYTHONPATH": ""}
    res = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_main_path_rehearsed_on_cpu():
    """chip_smoke.py's main-path phase at a tiny size on the CPU: prefill,
    decode, flush -> restore_kv -> decode, with its own checks (restored
    K/V, next greedy token). The plain versions run, so nothing launches."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    from hcache_deepspeed_tpu_torch.models.llama import llama_tiny
    res = chip_smoke.phase_main_path(
        llama_tiny(dtype="bfloat16", max_positions=512), "cpu",
        prompt_lens=(40, 30, 17, 5), decode_steps=4, num_blocks=32)
    assert res["next_token_after_restore"] == res["next_token_reference"]
    assert res["restore_tokens"] == \
        res["prompt_lens"][res["restore_uid"]] + 4
    assert set(res["launches"].values()) == {0}
