"""Test harness config: deterministic CPU backend with 8 virtual devices.

The reference has no mockable device backend (SURVEY §4); this framework is
designed so the whole stack runs on a virtual CPU mesh — multi-chip sharding
is validated without TPU hardware.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The env var JAX_PLATFORMS is ignored when a hardware platform plugin is
# registered; the config knob takes precedence reliably.
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from xgnn_tpu import synthetic  # noqa: E402


@pytest.fixture(scope="session")
def small_ds():
    return synthetic.make_synthetic_dataset(
        num_node=2000, avg_degree=8, feat_dim=32, num_class=8, seed=0
    )


@pytest.fixture(scope="session")
def learn_ds():
    """Planted-signal dataset: a GNN can genuinely learn on it."""
    return synthetic.make_synthetic_dataset(
        num_node=3000, avg_degree=8, feat_dim=32, num_class=6, seed=2,
        planted_signal=2.0, train_frac=0.3,
    )


@pytest.fixture(scope="session")
def tiny_ds():
    return synthetic.make_synthetic_dataset(
        num_node=200, avg_degree=5, feat_dim=16, num_class=4, seed=1,
        power_law=False,
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skips without one)"
    )
