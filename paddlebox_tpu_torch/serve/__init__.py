"""Online serving plane: atomic-swap scoring versions and a batched scorer.

- scoring_table.py  atomic-swap versions backing the scorers
- server.py         forward-only scoring + batched front-end
"""

from paddlebox_tpu_torch.serve.scoring_table import ScoringTable, TableVersion
from paddlebox_tpu_torch.serve.server import (
    ScoreServer,
    Scorer,
    ServeOverloadError,
    ServeTimeoutError,
    table_source,
    version_source,
)

__all__ = [
    "ScoringTable",
    "TableVersion",
    "Scorer",
    "ScoreServer",
    "ServeOverloadError",
    "ServeTimeoutError",
    "table_source",
    "version_source",
]
