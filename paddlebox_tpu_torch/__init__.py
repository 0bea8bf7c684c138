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
- ``models``   the model zoo as ``nn.Module``s (LR, DeepFM, Wide&Deep,
               DCN, MMoE and its task head, RankDeepFM); weight and
               Adam-state conversion from and to JAX
- ``train``    the training and eval step, the resident K-step feed,
               Adam, the async dense table, the pass trainer and its
               dense checkpoint, the checkpoint chain
               (CheckpointManager), pass rollback
- ``utils``    stats, fault injection, device selection, file writes
               (atomic, piped), dump writers, the ctypes binding of the
               native host tier (``csrc/*.cc``)
- ``boxps``    the ``BoxWrapper`` façade over table, metrics, dataset
               and publishing
- ``serve``    atomic-swap scoring table, scorer, batching server and the
               checkpoint follower

Entry points take an explicit ``device`` and default to ``"cuda"``; they
raise when no GPU is present unless the caller asks for ``device="cpu"``.
The package imports neither ``jax`` nor the JAX package.
"""

__version__ = "0.1.0"

from paddlebox_tpu_torch.boxps import BoxWrapper  # noqa: F401  (the reference's façade)
