"""The run's guard against the JAX package compares whole top-level names."""

from bench_port.core.guard import forbidden_modules


def test_rejects_jax_and_the_jax_package():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "paddlebox_tpu", "paddlebox_tpu.ops.pull_push"]
    assert forbidden_modules(names) == sorted(names)


def test_accepts_the_port_and_lookalikes():
    names = ["paddlebox_tpu_torch", "paddlebox_tpu_torch.train.trainer", "jaxtyping", "numpy", "torch", "bench_port"]
    assert forbidden_modules(names) == []


def test_this_process_holds_no_port_forbidden_module_after_importing_the_harness():
    import bench_port.core.runner  # noqa: F401
    import bench_port.loops.steady  # noqa: F401

    assert not [m for m in forbidden_modules() if m.startswith("paddlebox_tpu")]
