#!/usr/bin/env python3
"""The paged pool's write (``kv_pool_insert`` and its int8 form
``kv_pool_insert_q8``) timed on one CUDA card at the shapes
``chip_smoke.py`` holds it to: a decode tick's 16 rows, the serve cell's
first admission wave (16 rows x a 256-token window, pads aimed at block
P), and an attach wave's suffix written from mid-block after its
copy-on-write; GPT-2's 12-head pool and Llama's 4-head one; bf16 and f32.
Each is exact against the plain version and timed beside its byte bound,
the plain version and the indexed write (``chip_smoke.check_insert``,
``check_insert_q8``, ``check_insert_suffix``, ``pool_insert_times``).

    python3 insert_probe.py [--root DIR] [--out FILE]

``--root`` imports the port's package from another checkout, such as a
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, so that one card call can time two trees in turns
(parent, change, change, parent: one process each). That checkout builds
its kernels into its own ``build/``. The checks and the timing are this
file's ``chip_smoke.py``'s either way; a tree whose wrapper has no
``vec_bytes`` reports no vector width.

Prints the card's name and power limit (``nvidia-smi``) on one line and
the result as one JSON object on the last; ``--out`` writes it to a file
too.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_smoke():
    """This checkout's ``chip_smoke.py``, whatever ``--root`` puts first
    on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE),
                    help="the checkout whose port package is timed")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("insert_probe: no CUDA device", file=sys.stderr)
        return 2
    C = load_smoke()
    from distributed_compute_pytorch_tpu_torch.ops import _build
    from distributed_compute_pytorch_tpu_torch.ops import cache_update as CU
    if Path(CU.__file__).resolve().parents[2] != root:
        print(f"insert_probe: imported {CU.__file__}, not {root}'s port",
              file=sys.stderr)
        return 2
    if not hasattr(CU, "vec_bytes"):
        CU = types.SimpleNamespace(**vars(CU), vec_bytes=lambda *a, **k: None)
    smi = C.nvidia_smi()
    built = _build.build_all()
    kernels = {}
    for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        d = {}
        d["kv_pool_insert"], d["kv_pool_insert_admission"] = C.check_insert(
            torch, np, CU, dtype, dt)
        d["kv_pool_insert_q8"], d["kv_pool_insert_q8_admission"] = \
            C.check_insert_q8(torch, np, CU, dtype, dt)
        d["kv_pool_insert_llama"], d["kv_pool_insert_llama_admission"] = \
            C.check_insert(torch, np, CU, dtype, dt, H=C.LLAMA_KV_HEADS)
        for q8 in (False, True):
            d[f"kv_pool_insert{'_q8' if q8 else ''}_suffix"] = \
                C.check_insert_suffix(torch, CU, dtype, dt, q8)
        for res in d.values():
            name, mangled = res.pop("kernel")
            if res["vec_bytes"] is not None:
                res["kernel"] = name
            if CU.NAME in built["built"]:     # this process built it
                res["ptxas"] = C.kernel_resources(built["ptxas"][CU.NAME],
                                                  mangled)
        kernels[dt] = d
        torch.cuda.empty_cache()
    out = {"root": str(root), "card": smi,
           "device": torch.cuda.get_device_name(0),
           "launch_floor_ms": C.time_ms(
               torch, [lambda: torch.cuda._sleep(0)], iters=200),
           "kernels": kernels}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
