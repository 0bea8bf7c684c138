from paddlebox_tpu_torch.models.convert import (
    adam_state_from_optax,
    adam_state_to_optax,
    deepfm_params_from_jax,
    deepfm_params_to_jax,
    dense_from_jax_leaves,
    dense_leaf_names,
    dense_to_jax_leaves,
    rank_deepfm_params_from_jax,
    rank_deepfm_params_to_jax,
)
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.layers import linear_apply, linear_init, mlp_apply, mlp_init
from paddlebox_tpu_torch.models.rank import RankDeepFM

__all__ = [
    "mlp_init",
    "mlp_apply",
    "linear_init",
    "linear_apply",
    "DeepFM",
    "RankDeepFM",
    "deepfm_params_from_jax",
    "deepfm_params_to_jax",
    "rank_deepfm_params_from_jax",
    "rank_deepfm_params_to_jax",
    "adam_state_from_optax",
    "adam_state_to_optax",
    "dense_leaf_names",
    "dense_to_jax_leaves",
    "dense_from_jax_leaves",
]
