"""distributed_compute_pytorch_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (``distributed_compute_pytorch_tpu``),
which stays the reference. Module paths mirror the JAX package so each
ported module names its counterpart by location. The port imports
``torch`` and ``numpy`` only: never ``jax``, ``optax`` or anything of the
JAX package, whose jax-free helpers it keeps its own copies of.

Slice 1 is GPT-2 continuous-batching serving; slice 2 is single-GPU
GPT-2 training; slice 3 is one-shot KV-cache generation; a later slice
adds the reference's own workload, the MNIST ConvNet with Adadelta +
StepLR, trained data-parallel over ``torch.distributed``:

models    ``layers`` (Dense, Conv2d, max-pool, BatchNorm (sync-BN under a
          process group), LayerNorm, Embedding, dropout, the losses),
          ``transformer`` (pre-LN block: ``forward`` for a training step
          or a prefill, ``decode_step`` on the paged pool or the dense
          cache), ``gpt2`` (with the loss protocol), ``convnet``,
          ``registry``
ops       ``attention`` (dense reference math and the paged and dense
          write-and-attend), and one module per hand-written CUDA
          kernel family: ``flash_attention`` (forward, and the dQ and
          dK/dV backward kernels behind the ``FlashAttention`` autograd
          Function), ``cache_update`` (the paged pool and the dense K/V
          slot writes), ``decode_attention`` (the paged and dense decode
          reads, and the speculative verify step), ``fused_adamw`` (one
          launch over every parameter);
          ``_build`` compiles ``csrc/*.cu``
train     ``optim`` (Adadelta and SGD with StepLR, AdamW, fused AdamW,
          warmup-cosine), ``step`` (``make_step_fns``: bf16 compute over
          f32 masters, step-level accumulation, model state, data
          parallelism), ``checkpoint`` (v1 ``.npz``, params and model
          state in the JAX layout), ``trainer``, ``elastic`` (the
          preemption guard and restart backoff serving uses)
data      ``sampler``, ``datasets`` (MNIST, synthetic), ``loader``
          (``DeviceFeeder``, a rank's rows of each global batch)
core      ``config`` (the ``dcp-train`` flag subset), ``mesh`` (the
          process group: ``nccl`` on CUDA, ``gloo`` on the CPU)
utils     ``logging`` (the reference's lines, rank 0), ``fsio``
kv_pool   host-side refcounted block pool and the radix prefix cache
serve     ``ContinuousBatcher`` (per-row sampling, the prefix cache,
          chunked prefill, width buckets, speculative decoding, the KV
          tiers, the request lifecycle of ``serve_detailed`` and session
          reconstruction)
serve_lifecycle  ``RequestResult``, statuses, ``ChaosInjector``, the
          tick watchdog's ``TickTimeout``
serve_journal  the write-ahead session journal and ``recover``
spec_decode  speculation's ``SpecConfig`` and proposers
infer     ``prefill``, ``generate`` (greedy, top-k / nucleus sampling)
cli       the ``dcp-train`` subset; cli_serve the ``dcp-serve`` subset;
          cli_generate the ``dcp-generate`` subset
interop   JAX GPT-2 and ConvNet params, reference ``mnist.pt`` state
          dicts and v1 checkpoints <-> this package

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``device.resolve_device``); without a card they raise.
"""

__version__ = "0.1.0"
