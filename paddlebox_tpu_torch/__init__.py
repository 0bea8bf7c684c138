"""paddlebox_tpu_torch — the PyTorch and CUDA port of the JAX package.

The same system, for an NVIDIA H100: slot samples, a pass working-set
table on the device, the sparse pull and push, fused seqpool+CVM, CTR models,
online AUC and a batched scoring server. Subpackages mirror the JAX
package's names so each counterpart is easy to find:

- ``data``     slot schema, parsers (Python and native), the columnar
               record store, batch packers, the prefetch pipeline, the
               pass dataset
- ``table``    value layouts, the host store (native or Python) with its
               disk tier and its base/delta saves, the pass working set,
               replica cache
- ``ops``      sparse pull and push (hand-written CUDA row gather and
               row writeback), seqpool+CVM
- ``metrics``  online AUC
- ``models``   DeepFM as an ``nn.Module``; weight and Adam-state
               conversion from and to JAX
- ``train``    the training and eval step, the resident K-step feed,
               Adam, the pass trainer and its dense checkpoint, the
               checkpoint chain (CheckpointManager), pass rollback
- ``utils``    stats, fault injection, device selection, atomic file
               writes, the ctypes binding of the native host tier
               (``csrc/*.cc``)
- ``serve``    atomic-swap scoring table, scorer, batching server and the
               checkpoint follower

Entry points take an explicit ``device`` and default to ``"cuda"``; they
raise when no GPU is present unless the caller asks for ``device="cpu"``.
The package imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"
