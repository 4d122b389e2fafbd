"""The port's trainer CLI on the CPU: ``--device cpu --model gpt2
--model_preset tiny --dataset synthetic-lm --optimizer adamw --batch_size
256`` (8 steps an epoch; the dataset sizes the model to vocab 256 and
T 128).

- the reference-format lines;
- a v1 checkpoint whose params the JAX package's
  ``checkpoint.restore_params`` reads into its GPT-2-tiny template, and
  which the port's ``cli_serve --ckpt_path`` serves;
- with ``--keep_last 2`` a corrupted newest file falls back to
  ``.prev-1``, here a mid-epoch ``--checkpoint_every`` save, which resumes
  on the exact next batch and ends bit for bit where the uninterrupted
  epoch ended;
- ``--resume`` continues at the next epoch;
- the feeder gives the JAX feeder's batches for one seed, padding, skip
  and validity mask included;
- without ``--device cpu`` the CLI raises the device rule's
  ``RuntimeError``; a flag outside the ported subset exits with a
  one-line error naming it (``--nonfinite_policy skip`` is ported:
  ``tests/test_torch_train_guard.py``).
"""

import contextlib
import dataclasses
import io
import json
import re
import shutil

import jax
import numpy as np
import pytest
import torch

from distributed_compute_pytorch_tpu.core.mesh import make_mesh
from distributed_compute_pytorch_tpu.data.datasets import (
    synthetic_images as jax_synthetic_images)
from distributed_compute_pytorch_tpu.data.loader import (
    DeviceFeeder as JaxDeviceFeeder)
from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.train.checkpoint import restore_params
from distributed_compute_pytorch_tpu_torch import cli, cli_serve
from distributed_compute_pytorch_tpu_torch.data.datasets import (
    synthetic_images)
from distributed_compute_pytorch_tpu_torch.data.loader import DeviceFeeder
from distributed_compute_pytorch_tpu_torch.interop import (
    gpt2_params_from_jax, read_checkpoint)
from distributed_compute_pytorch_tpu_torch.train import checkpoint

BASE = ["--device", "cpu", "--model", "gpt2", "--model_preset", "tiny",
        "--dataset", "synthetic-lm", "--optimizer", "adamw",
        "--batch_size", "256", "--log_every", "4"]
TRAIN_LINE = re.compile(r"^epoch: (\d+) \[(\d+)/8 \(\d+%\)\]\t Loss:[\d.]+$",
                        re.M)
EVAL_LINE = re.compile(r"^Test set: Average loss: [\d.]+, Accuracy: "
                       r"\d+/260096 \(\d+%\)$", re.M)
TIME_LINE = re.compile(r"^time to complete this epoch: [\d.]+ seconds "
                       r"\([\d.]+ samples/s\)$", re.M)


def _run(capsys, *args):
    assert cli.main(BASE + list(args)) == 0
    out = capsys.readouterr()
    return out.out, out.err


def _params(path):
    flat, manifest = read_checkpoint(path)
    return {k: v for k, v in flat.items() if k.startswith(".params")}, manifest


@pytest.fixture(scope="module")
def run1(tmp_path_factory):
    """One epoch with a mid-epoch save at step 4 (rotated to ``.prev-1``
    by the end-of-epoch save)."""
    d = tmp_path_factory.mktemp("run1")
    ck = str(d / "ck.npz")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(BASE + ["--epochs", "1", "--ckpt_path", ck,
                                "--checkpoint_every", "4",
                                "--keep_last", "2"]) == 0
    return ck, buf.getvalue()


def test_reference_lines_and_checkpoint(run1):
    ck, out = run1
    steps = [(int(e), int(b)) for e, b in TRAIN_LINE.findall(out)]
    assert steps == [(0, 0), (0, 4)]
    assert EVAL_LINE.search(out) and TIME_LINE.search(out)
    _, manifest = _params(ck)
    assert manifest["format"] == 1 and manifest["epoch"] == 0
    _, mid = _params(ck + ".prev-1")
    assert mid["extra"] == {"step_in_epoch": 4}


def test_jax_restore_params_and_port_serve_read_it(run1, tmp_path, capsys):
    ck, _ = run1
    cfg = dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128)
    template, _ = JaxGPT2(cfg).init(jax.random.key(0))
    restored = jax.tree.map(np.asarray, restore_params(ck, template))
    flat, _ = _params(ck)
    for name, t in gpt2_params_from_jax(restored).items():
        assert t.shape == gpt2_params_from_jax(
            jax.tree.map(np.asarray, template))[name].shape
    np.testing.assert_array_equal(restored["blocks"]["qkv"]["kernel"],
                                  flat[".params::blocks::qkv::kernel"])
    reqs = tmp_path / "reqs.txt"
    reqs.write_text("5,9,12\n7\n")
    assert cli_serve.main(["--device", "cpu", "--ckpt_path", ck,
                           "--model_preset", "tiny", "--max_seq_len", "128",
                           "--requests", str(reqs), "--slots", "2",
                           "--segment", "4", "--max_new_tokens", "3"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [len(x["new"]) for x in lines] == [3, 3]
    assert all(x["status"] == "ok" for x in lines)


def test_corrupt_newest_falls_back_to_a_mid_epoch_save(run1, tmp_path,
                                                       capsys):
    """The newest file corrupted, ``--keep_last 2`` restores ``.prev-1``,
    the step-4 save, resumes on batch 4 and ends the epoch bit for bit
    where the uninterrupted run ended."""
    ck, _ = run1
    mid = str(tmp_path / "ck.npz")
    shutil.copy(ck + ".prev-1", mid + ".prev-1")
    # rewrite one leaf of the newest file with wrong bytes: its CRC-32 no
    # longer matches
    with np.load(ck) as z:
        flat = {k: z[k] for k in z.files}
    flat[".params::ln_f::bias"] = flat[".params::ln_f::bias"] + 1.0
    np.savez(mid, **flat)
    out, err = _run(capsys, "--epochs", "1", "--ckpt_path", mid, "--resume",
                    "--keep_last", "2")
    assert "newest checkpoint corrupt" in err and ".prev-1" in err
    assert "at epoch 0 step 4" in out
    assert [int(b) for _, b in TRAIN_LINE.findall(out)] == [4]
    got, _ = _params(mid)
    want, _ = _params(ck)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resume_continues_at_the_next_epoch(run1, tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    shutil.copy(run1[0], ck)
    out, _ = _run(capsys, "--epochs", "2", "--ckpt_path", ck, "--resume",
                  "--keep_last", "2")
    assert re.search(r"resumed from .* at epoch 1$", out, re.M)
    assert {int(e) for e, _ in TRAIN_LINE.findall(out)} == {1}
    assert EVAL_LINE.search(out) and TIME_LINE.search(out)
    assert checkpoint.load_manifest(ck)["epoch"] == 1
    assert checkpoint.load_manifest(ck + ".prev-1")["epoch"] == 0


def test_cli_needs_cuda_unless_cpu_is_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    args = [a for a in BASE if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(args + ["--ckpt_path", str(tmp_path / "ck.npz")])


@pytest.mark.parametrize("flag,arg", [("--mesh", "data=2"),
                                      ("--gamma", "0.7"),
                                      ("--divergence_check", None)])
def test_unported_flag_exits_naming_it(flag, arg, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(BASE + [flag] + ([] if arg is None else [arg]))
    msg = str(e.value)
    assert flag in msg and "\n" not in msg


def test_feeder_batches_match_jax():
    """10 examples in batches of 4: shuffled, epoch-keyed order, the last
    batch wrapped around (2 padded rows, weighted 0 by ``valid``), and a
    mid-epoch ``skip``."""
    data = synthetic_images(10, (3, 2, 1), 5, seed=4)
    jdata = jax_synthetic_images(10, (3, 2, 1), 5, seed=4)
    np.testing.assert_array_equal(data.inputs, jdata.inputs)
    mesh = make_mesh("data=1", devices=jax.devices()[:1])
    ours = DeviceFeeder(data, 4, "cpu", seed=7)
    ref = JaxDeviceFeeder(jdata, mesh, 4, seed=7, prefetch=0)
    assert ours.steps_per_epoch == ref.steps_per_epoch == 3
    for epoch, skip in ((0, 0), (1, 0), (1, 2)):
        got = list(ours.epoch(epoch, skip=skip, with_valid=True))
        want = list(ref.epoch(epoch, skip=skip, with_valid=True))
        assert len(got) == len(want) == 3 - skip
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[-1][2].tolist() == [1.0, 1.0, 0.0, 0.0]
