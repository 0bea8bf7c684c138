"""fleet: the distributed-strategy / role / launch tier.

Port of the JAX package's ``fleet`` package: ``DistributedStrategy``
translates fleet v2's strategy flags onto the port's mechanisms
(strategy.py), ``RoleMaker`` reads the launcher's environment and
``init_distributed`` creates the process group (role_maker.py), and
``Zero1Optimizer`` shards the dense Adam state over the mesh (zero.py).
"""

from paddlebox_tpu_torch.fleet.role_maker import RoleMaker, init_distributed
from paddlebox_tpu_torch.fleet.strategy import DistributedStrategy
from paddlebox_tpu_torch.fleet.zero import Zero1Optimizer

__all__ = [
    "DistributedStrategy",
    "RoleMaker",
    "init_distributed",
    "Zero1Optimizer",
]
