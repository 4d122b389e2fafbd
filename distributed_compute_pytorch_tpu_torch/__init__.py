"""distributed_compute_pytorch_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``distributed_compute_pytorch_tpu``),
which stays the reference. Module paths mirror the JAX package so each
ported module names its counterpart by location. The port imports
``torch`` and ``numpy`` only: never ``jax``, ``optax`` or anything of the
JAX package, whose jax-free helpers it keeps its own copies of.

Slice 1 is GPT-2 continuous-batching serving:

models    ``layers`` (Dense, LayerNorm, Embedding), ``transformer``
          (pre-LN block: prefill ``forward`` and paged ``decode_step``),
          ``gpt2``, ``registry``
ops       ``attention`` (dense reference math and the paged
          write-and-attend), and one module per hand-written CUDA
          kernel: ``flash_attention`` (admission prefill),
          ``cache_update`` (paged K/V slot write), ``decode_attention``
          (paged decode read); ``_build`` compiles ``csrc/*.cu``
kv_pool   host-side refcounted block pool
serve     ``ContinuousBatcher`` (greedy)
cli_serve the ``dcp-serve`` subset
interop   JAX GPT-2 params and v1 checkpoints -> this package

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``); without a card they raise.
"""

__version__ = "0.1.0"
