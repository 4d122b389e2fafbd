"""The port's prefix handoff (``ContinuousBatcher.export_prefix`` /
``import_prefix`` / ``prefix_match_len``) on the CPU in f32: the scenarios
of ``tests/test_serve_prefill.py``'s handoff tests and
``tests/test_kv_quant.py``'s int8 handoff tests, pointed at the port —
export then import continues exactly as one batcher does, a corrupted
payload is declined with nothing half-imported, an export from the host
tier, int8 payloads with their scales and the scale-CRC and dtype declines,
the weights-version decline — and across the packages: a JAX payload
imported by the port continues as the JAX batcher does, a port payload
imported by the JAX batcher continues as the port does, and the two
packages' payloads for one prompt agree to 1e-5 (f32 K/V computed by two
frameworks' kernels; the tokens and block layout are equal exactly)."""

import dataclasses

import jax
import numpy as np
import pytest

from distributed_compute_pytorch_tpu.models.gpt2 import (
    GPT2 as JaxGPT2, GPT2Config as JaxGPT2Config)
from distributed_compute_pytorch_tpu.serve import (
    ContinuousBatcher as JaxBatcher, Request as JaxRequest)
from distributed_compute_pytorch_tpu_torch import interop
from distributed_compute_pytorch_tpu_torch.kv_pool import TIER_HOST
from distributed_compute_pytorch_tpu_torch.kv_tier import _crc
from distributed_compute_pytorch_tpu_torch.models.gpt2 import GPT2, GPT2Config
from distributed_compute_pytorch_tpu_torch.serve import (
    ContinuousBatcher, Request)

COMMON = dict(slots=2, t_max=64, prompt_buf=24, segment=3, prefix_cache=True)
# the int8 cases (the reference's int8 block of 32 slots)
Q8 = dict(slots=1, t_max=64, prompt_buf=40, segment=4, prefix_cache=True,
          pool_blocks=8, kv_block_tokens=32, kv_dtype="int8")
# two frameworks' f32 K/V for one prompt
PAYLOAD_TOL = 1e-5


@pytest.fixture(scope="module")
def gpt2():
    """JAX GPT-2-tiny (positions lifted to 128) and the port's copy of its
    weights."""
    jm = JaxGPT2(dataclasses.replace(JaxGPT2Config.tiny(), max_seq_len=128))
    params, _ = jm.init(jax.random.key(0))
    tm = interop.load_gpt2_params(
        GPT2(dataclasses.replace(GPT2Config.tiny(), max_seq_len=128),
             device="cpu"), jax.tree.map(np.asarray, params))
    return jm, params, tm


def _cb(gpt2, **kw):
    return ContinuousBatcher(gpt2[2], **{**COMMON, **kw}, device="cpu")


def _jcb(gpt2, **kw):
    jm, params, _ = gpt2
    return JaxBatcher(jm, params, decode_width_buckets=1, **{**COMMON, **kw})


def _prompt(seed, n=17):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, 256, size=n)]


def test_handoff_bit_exact_vs_replay_fallback(gpt2):
    """Export then import moves the prompt's blocks between two pools and
    the continuation equals the single-batcher stream; a payload with a bad
    CRC is declined (counted, no exception, nothing half-imported) and the
    continuation still matches through prefill."""
    prompt = _prompt(13)
    want = _cb(gpt2).serve([Request(list(prompt), 6)])[0]
    src = _cb(gpt2)
    first = src.serve([Request(list(prompt), 1)])[0]
    payload = src.export_prefix(prompt + first)
    assert payload is not None and payload["n_tokens"] == 16
    assert payload["kv"].shape == (2, 2, 2, 4, 8, 16)
    assert payload["crc"] == _crc(payload["kv"])
    assert src.prefill["handoff_exports"] == 1
    assert src.prefill["handoff_bytes"] == payload["kv"].nbytes
    dst = _cb(gpt2)
    assert dst.import_prefix(payload)
    assert dst.prefill["handoff_imports"] == 1
    assert dst.prefix_match_len(prompt) == 16
    cont = dst.serve([Request(prompt + first, 5)])[0]
    assert first + cont == want
    assert dst.last_cached_prefix == [16] and dst.last_block_leaks == 0
    fb = _cb(gpt2)
    assert fb.import_prefix(dict(payload, crc=payload["crc"] ^ 1)) is False
    assert fb.prefill["handoff_declined"] == 1
    assert fb.prefix_match_len(prompt) == 0
    assert fb._pool.allocated == 1          # the trash block alone
    cont = fb.serve([Request(prompt + first, 5)])[0]
    assert first + cont == want
    assert fb.last_block_leaks == 0


def test_handoff_export_from_host_tier(gpt2):
    """A demoted entry exports straight from the host tier, and the
    importer's continuation equals the single-batcher stream."""
    prompt = _prompt(15)
    src = _cb(gpt2, slots=1, t_max=32, segment=4, pool_blocks=8,
              host_cache_blocks=16)
    first = src.serve([Request(list(prompt), 1)])[0]
    (e,) = src._radix.entries
    src._radix.evict_for(src._pool.num_blocks, src._tier_demote)
    assert e.tier == TIER_HOST
    payload = src.export_prefix(prompt + first)
    assert payload is not None and payload["n_tokens"] == 16
    assert e.tier == TIER_HOST and e.host_blocks   # read, not released
    dst = _cb(gpt2)
    assert dst.import_prefix(payload)
    want = _cb(gpt2).serve([Request(list(prompt), 6)])[0]
    assert first + dst.serve([Request(prompt + first, 5)])[0] == want
    assert src._tier.leak_check() == 0


def test_import_into_host_tier_promotes(gpt2):
    """With a host tier the import enters as a demoted entry (no device
    blocks until it is matched) and the first admission promotes it."""
    prompt = _prompt(17)
    src = _cb(gpt2)
    first = src.serve([Request(list(prompt), 1)])[0]
    payload = src.export_prefix(prompt + first)
    dst = _cb(gpt2, host_cache_blocks=8)
    assert dst.import_prefix(payload)
    (e,) = dst._radix.entries
    assert e.tier == TIER_HOST and dst._pool.allocated == 1
    want = _cb(gpt2).serve([Request(list(prompt), 6)])[0]
    assert first + dst.serve([Request(prompt + first, 5)])[0] == want
    assert dst.tier["promotions"] == 1 and dst.last_cached_prefix == [16]
    assert dst.last_host_block_leaks == 0


def test_handoff_int8_export_import(gpt2):
    """An int8 payload carries the blocks' int8 bytes and f32 scales with
    its own scale CRC; the importer attaches and serves the exporter's
    tokens; ``bytes_saved_handoff`` counts the float payload it replaced."""
    prompt = _prompt(29, 33)
    src = _cb(gpt2, **Q8)
    dst = _cb(gpt2, **Q8)
    src.serve([Request(prompt + [3, 4], 6)])
    pay = src.export_prefix(prompt + [7])
    assert pay is not None and pay["kv_dtype"] == "int8"
    assert pay["kv"].dtype == np.int8 and pay["scale"].dtype == np.float32
    assert pay["scale_crc"] == _crc(pay["scale"])
    assert src.kvq["bytes_saved_handoff"] == (
        pay["kv"].nbytes * 2 - pay["kv"].nbytes - pay["scale"].nbytes)
    assert dst.import_prefix(pay)
    reqs = [Request(prompt + [5, 6], 6)]
    assert dst.serve(reqs) == src.serve(reqs)
    assert dst.stats["prefix_hits"] >= 1 and dst.last_block_leaks == 0


def test_handoff_corrupt_scale_and_dtype_decline(gpt2):
    """A flipped scale fails ``scale_crc``; an int8 payload into a float
    pool, and the reverse, decline on the dtype stamp's own counter;
    nothing changes in the importer and nothing raises."""
    prompt = _prompt(31, 33)
    src = _cb(gpt2, **Q8)
    src.serve([Request(prompt + [3, 4], 6)])
    pay = src.export_prefix(prompt + [7])
    sc = np.array(pay["scale"])
    sc.flat[0] += 1.0
    dst = _cb(gpt2, **Q8)
    assert not dst.import_prefix({**pay, "scale": sc})
    assert dst.prefill["handoff_declined"] == 1
    assert dst.kvq["handoff_dtype_declined"] == 0
    assert not dst.import_prefix({k: v for k, v in pay.items()
                                  if k != "scale"})
    assert dst.prefill["handoff_declined"] == 2
    assert not dst._radix.entries and dst._pool.allocated == 1
    bf = _cb(gpt2, **{**Q8, "kv_dtype": "bf16"})
    assert not bf.import_prefix(pay)
    assert bf.kvq["handoff_dtype_declined"] == 1
    assert bf.prefill["handoff_declined"] == 1
    bf.serve([Request(prompt + [3, 4], 6)])
    bpay = bf.export_prefix(prompt + [7])
    assert bpay is not None and "scale" not in bpay
    q8 = _cb(gpt2, **Q8)
    assert not q8.import_prefix(bpay)
    assert q8.kvq["handoff_dtype_declined"] == 1


def test_handoff_weights_version_and_geometry_declines(gpt2):
    """A payload of other weights declines on ``fleet["version_declined"]``;
    a payload of another block size, shape or element type declines; none
    raises and none leaves anything behind."""
    prompt = _prompt(33)
    src = _cb(gpt2)
    src.serve([Request(list(prompt), 1)])
    pay = src.export_prefix(prompt + [1])
    dst = _cb(gpt2)
    assert not dst.import_prefix(dict(pay, weights_version=1))
    assert dst.fleet["version_declined"] == 1
    dst.weights_version = 1
    assert not dst.import_prefix(pay)
    assert dst.fleet["version_declined"] == 2
    dst.weights_version = 0
    kv16 = pay["kv"].astype(np.float16)
    for bad in (dict(pay, bt=16), dict(pay, n_tokens=8),
                dict(pay, kv=pay["kv"][:, :, :1]),
                dict(pay, kv=kv16, crc=_crc(kv16))):
        assert not dst.import_prefix(bad)
    assert dst.prefill["handoff_declined"] == 6
    assert not dst._radix.entries and dst._pool.allocated == 1
    assert dst.import_prefix(pay)


# ---- across the packages ------------------------------------------------------


def test_jax_payload_imported_by_port(gpt2):
    """The JAX batcher's export imports into the port (f32: its bytes and
    CRC as they are) and the port continues exactly as the JAX batcher does
    on one pool; the port's export imports into the JAX batcher, which
    continues exactly as the port does; the two payloads agree to
    ``PAYLOAD_TOL``."""
    prompt = _prompt(41)
    jsrc = _jcb(gpt2)
    first = jsrc.serve([JaxRequest(list(prompt), 1)])[0]
    jpay = jsrc.export_prefix(prompt + first)
    want = _jcb(gpt2).serve([JaxRequest(list(prompt), 6)])[0]
    dst = _cb(gpt2)
    assert dst.import_prefix(jpay)
    assert first + dst.serve([Request(prompt + first, 5)])[0] == want
    assert dst.last_cached_prefix == [16]

    psrc = _cb(gpt2)
    assert psrc.serve([Request(list(prompt), 1)])[0] == first
    ppay = psrc.export_prefix(prompt + first)
    for key in ("tokens", "n_tokens", "bt", "kv_dtype", "weights_version"):
        assert ppay[key] == jpay[key], key
    assert ppay["kv"].shape == jpay["kv"].shape
    assert ppay["kv"].dtype == np.asarray(jpay["kv"]).dtype
    np.testing.assert_allclose(ppay["kv"], jpay["kv"], rtol=0,
                               atol=PAYLOAD_TOL)
    jdst = _jcb(gpt2)
    assert jdst.import_prefix(ppay)
    assert first + jdst.serve([JaxRequest(prompt + first, 5)])[0] == want
    assert jdst.prefill["handoff_imports"] == 1
