"""Online serving plane: atomic-swap scoring versions and a batched scorer.

- scoring_table.py  atomic-swap versions backing the scorers
- server.py         forward-only scoring + batched front-end
- follower.py       tails a checkpoint root into a ScoringTable
- fleet.py          the fleet: shared staging, followers behind a transport
                    rank, and the hedging front-end client
"""

from paddlebox_tpu_torch.serve.follower import Follower, apply_published_chain, verify_chain_link
from paddlebox_tpu_torch.serve.fleet import (
    FleetClient,
    FleetFollower,
    FleetStage,
    FleetView,
    ServeRequestError,
)

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
    "FleetClient",
    "FleetFollower",
    "FleetStage",
    "FleetView",
    "ServeRequestError",
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
