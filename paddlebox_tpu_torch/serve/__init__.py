"""Online serving plane: atomic-swap scoring versions and a batched scorer.

- scoring_table.py  atomic-swap versions backing the scorers
- server.py         forward-only scoring + batched front-end
- follower.py       tails a checkpoint root into a ScoringTable
"""

from paddlebox_tpu_torch.serve.follower import Follower, apply_published_chain, verify_chain_link

from paddlebox_tpu_torch.serve.scoring_table import (
    DeviceScoringTier,
    ScoringTable,
    TableVersion,
    build_device_tier,
)
from paddlebox_tpu_torch.serve.server import (
    ScoreServer,
    Scorer,
    ServeOverloadError,
    ServeTimeoutError,
    table_source,
    version_source,
)

__all__ = [
    "Follower",
    "apply_published_chain",
    "verify_chain_link",
    "DeviceScoringTier",
    "ScoringTable",
    "TableVersion",
    "build_device_tier",
    "Scorer",
    "ScoreServer",
    "ServeOverloadError",
    "ServeTimeoutError",
    "table_source",
    "version_source",
]
