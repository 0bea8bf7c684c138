"""A cell's configuration and mix cut to a size the CPU runs in seconds."""

import functools

import torch

SMALL = {
    "config": {"records_per_pass": 2048, "key_space": 50_000, "hidden": [32, 16]},
    "traffic": {"batch": 256, "files": 2, "hot_keys": 64},
}


def fp32_tower(monkeypatch):
    """Run the port's towers in fp32, so the port and the reference agree to
    fp32 rounding and any gap is the planted fault's."""
    import paddlebox_tpu_torch.models.deepfm as deepfm
    import paddlebox_tpu_torch.models.layers as layers
    import paddlebox_tpu_torch.models.wide_deep as wide_deep

    f32 = functools.partial(layers.mlp_apply, compute_dtype=torch.float32)
    monkeypatch.setattr(deepfm, "mlp_apply", f32)
    monkeypatch.setattr(wide_deep, "mlp_apply", f32)
