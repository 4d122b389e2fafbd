"""distributed_compute_pytorch_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``distributed_compute_pytorch_tpu``),
which stays the reference. Module paths mirror the JAX package so each
ported module names its counterpart by location. The port imports
``torch`` and ``numpy`` only: never ``jax``, ``optax`` or anything of the
JAX package, whose jax-free helpers it keeps its own copies of.

Slice 1 is GPT-2 continuous-batching serving; slice 2 is single-GPU
GPT-2 training; slice 3 is one-shot KV-cache generation:

models    ``layers`` (Dense, LayerNorm, Embedding, dropout, the losses),
          ``transformer`` (pre-LN block: ``forward`` for a training step
          or a prefill, ``decode_step`` on the paged pool or the dense
          cache), ``gpt2``
          (with the loss protocol), ``registry``
ops       ``attention`` (dense reference math and the paged and dense
          write-and-attend), and one module per hand-written CUDA
          kernel family: ``flash_attention`` (forward, and the dQ and
          dK/dV backward kernels behind the ``FlashAttention`` autograd
          Function), ``cache_update`` (the paged pool and the dense K/V
          slot writes), ``decode_attention`` (the paged and dense decode
          reads), ``fused_adamw`` (one launch over every parameter);
          ``_build`` compiles ``csrc/*.cu``
train     ``optim`` (AdamW, fused AdamW, warmup-cosine), ``step``
          (``make_step_fns``: bf16 compute over f32 masters, step-level
          accumulation), ``checkpoint`` (v1 ``.npz``, params in the JAX
          layout), ``trainer``
data      ``sampler``, ``datasets`` (synthetic), ``loader``
          (``DeviceFeeder``)
core      ``config`` (the ``dcp-train`` flag subset)
utils     ``logging`` (the reference's lines), ``fsio``
kv_pool   host-side refcounted block pool
serve     ``ContinuousBatcher`` (greedy)
infer     ``prefill``, ``generate`` (greedy, top-k / nucleus sampling)
cli       the ``dcp-train`` subset; cli_serve the ``dcp-serve`` subset;
          cli_generate the ``dcp-generate`` subset
interop   JAX GPT-2 params and v1 checkpoints <-> this package

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``); without a card they raise.
"""

__version__ = "0.1.0"
