"""Package rules of the port: it imports no JAX (and nothing of the JAX
package), neither do ``chip_smoke.py``, ``train_probe.py``,
``ddp_probe.py`` and the CUDA test file, and its entry points refuse to
run without a card unless the caller asks for the CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "distributed_compute_pytorch_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "optax", "distributed_compute_pytorch_tpu"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def _checked_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "train_probe.py",
                                         ROOT / "ddp_probe.py",
                                         ROOT / "tests/test_torch_cuda.py"]


@pytest.mark.parametrize("path", _checked_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_leaves_jax_unloaded():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n"
                      for m in mods)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            + repr(FORBIDDEN) + ")\n"
            + "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from distributed_compute_pytorch_tpu_torch.cli_generate import (
        main as generate_main)
    from distributed_compute_pytorch_tpu_torch.cli_serve import main
    from distributed_compute_pytorch_tpu_torch.infer import generate
    from distributed_compute_pytorch_tpu_torch.models.gpt2 import (
        GPT2, GPT2Config)
    from distributed_compute_pytorch_tpu_torch.serve import ContinuousBatcher
    with pytest.raises(RuntimeError, match="CUDA"):
        GPT2(GPT2Config.tiny())
    model = GPT2(GPT2Config.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ContinuousBatcher(model, slots=1, t_max=16, prompt_buf=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--init_seed", "0", "--model_preset", "tiny",
              "--requests", "-"])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_main(["--init_seed", "0", "--model_preset", "tiny",
                       "--prompt", "5"])
    # generate runs where its model lives: on the CPU only when asked for
    assert generate(model, [[5, 9]], 2).device.type == "cpu"
    for flag in (["--device", "cpu"], ["--force-cpu"]):
        assert generate_main(["--init_seed", "0", "--model_preset", "tiny",
                              "--prompt", "5", "--max_new_tokens", "2",
                              *flag]) == 0


@pytest.mark.parametrize("name, kw", [("resnet18", {}), ("resnet50", {}),
                                      ("bert", {"preset": "tiny"}),
                                      ("llama", {"preset": "tiny"})])
def test_ladder_models_need_cuda_unless_cpu_is_asked(name, kw):
    """BASELINE's ResNet and BERT rungs and Llama follow the device rule:
    built without a card and without ``device="cpu"``, they raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from distributed_compute_pytorch_tpu_torch.models.registry import (
        build_model)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(name, **kw)
    assert build_model(name, device="cpu", **kw).device.type == "cpu"


def test_cuda_kernels_refuse_cpu_tensors():
    """The CUDA launchers never run a plain version: a CPU tensor raises
    (the dispatchers, not the launchers, pick the plain path)."""
    from distributed_compute_pytorch_tpu_torch.ops.cache_update import (
        cache_insert_cuda, kv_insert_cuda, kv_insert_rows_cuda,
        kv_pool_insert_cuda)
    from distributed_compute_pytorch_tpu_torch.ops.decode_attention import (
        dense_decode_cuda, paged_decode_cuda)
    from distributed_compute_pytorch_tpu_torch.ops.flash_attention import (
        flash_fwd)
    q = torch.zeros(1, 2, 1, 8)
    pool = torch.zeros(2, 3, 2, 4, 8)
    i32 = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_fwd(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        kv_pool_insert_cuda(pool, q[:, :, 0], q[:, :, 0], i32, i32)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_cuda(q, pool, i32[:, None], i32)
    cache = torch.zeros(2, 1, 2, 4, 8)             # [2, B, Hk, T, hd]
    with pytest.raises(ValueError, match="CUDA"):
        cache_insert_cuda(cache[0], q, i32[0])
    with pytest.raises(ValueError, match="CUDA"):
        kv_insert_cuda(cache, q, q, i32[0])
    with pytest.raises(ValueError, match="CUDA"):
        kv_insert_rows_cuda(cache, q, q, i32)
    with pytest.raises(ValueError, match="CUDA"):
        dense_decode_cuda(q, cache, i32, slot_mask=torch.ones(1, 4,
                                                              dtype=torch.bool))


def test_training_kernel_launchers_refuse_cpu_tensors():
    """The fused AdamW launcher never runs its plain version; the flash
    backward's launch checks refuse a CPU tensor before anything launches
    (its wrappers, like the dispatchers, send CPU tensors to the plain
    version instead)."""
    from distributed_compute_pytorch_tpu_torch.ops.flash_attention import (
        _bwd_prepare)
    from distributed_compute_pytorch_tpu_torch.ops.fused_adamw import (
        fused_adamw_cuda)
    buf = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_adamw_cuda(buf, buf, buf, buf, torch.zeros(4),
                         torch.zeros((), dtype=torch.int32),
                         torch.tensor(True), b1=0.9, b2=0.999, eps=1e-8)
    q, lse = torch.zeros(1, 2, 4, 8), torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        _bwd_prepare("flash_bwd_dkv", q, q, q, q, lse, lse, True, None)


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    """Loading a kernel where ``nvcc`` is missing raises, naming it; the
    library name follows the source bytes, so an edited source never
    loads a stale library."""
    from distributed_compute_pytorch_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("paged_decode")
    names = {_build._lib_path(k).name for k in _build.KERNELS}
    assert len(names) == len(_build.KERNELS)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "paged_decode.cu").write_bytes(
        (_build.CSRC / "paged_decode.cu").read_bytes() + b"\n")
    monkeypatch.setattr(_build, "CSRC", src)
    assert _build._lib_path("paged_decode").name not in names


def test_cuda_tests_skip_here_not_fake():
    """The CUDA kernel tests exist, carry the ``cuda`` marker, and skip
    (they count no pass) where there is no card."""
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-q",
         "-p", "no:cacheprovider", "-m", "cuda", "-rs",
         "tests/test_torch_cuda.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    out = res.stdout
    if torch.cuda.is_available():
        assert res.returncode == 0, out
    else:
        assert res.returncode == 0 and " passed" not in out, out
        assert "skipped" in out and "no CUDA device" in out, out
