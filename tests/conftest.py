import os

# Keep unit tests single-device (the 512-device override belongs ONLY to
# launch/dryrun.py, which sets XLA_FLAGS before importing jax itself).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels); "
        "skips on a host without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


def require_host_devices(n: int) -> None:
    """Skip (never vacuously pass) a test that needs ``n`` forced host
    devices. XLA_FLAGS must be set before the FIRST jax import of the
    process — an in-test os.environ write silently no-ops once jax is
    initialized, which is exactly the failure mode this guard replaces —
    so multi-device suites run in a dedicated invocation (`make sharded`,
    the CI `sharded` step, or an 8-device subprocess)."""
    if jax.device_count() < n:
        pytest.skip(
            f"needs {n} host devices, have {jax.device_count()}; run with "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n} set "
            "before the first jax import (e.g. `make sharded`)")


@pytest.fixture
def host_devices():
    """Fixture form of :func:`require_host_devices` — usage:
    ``host_devices(4)`` at the top of a multi-device test."""
    return require_host_devices


def make_extras(cfg, batch, seq, key=None, dtype=jnp.float32):
    """Modality extras required by a config's family (stub frontends)."""
    from repro.models import frontend
    key = key if key is not None else jax.random.PRNGKey(42)
    extras = {}
    if cfg.family == "vlm":
        extras["image_embeds"] = frontend.vision_embeddings(
            key, batch, cfg.n_image_tokens, cfg.d_model, dtype)
    elif cfg.family == "audio":
        extras["frames"] = frontend.audio_frames(
            key, batch, cfg.encoder_seq, cfg.d_model, dtype)
    elif cfg.family == "moe" and cfg.attn_chunk is not None:
        # llama4 early fusion
        n_img = min(8, seq)
        extras["image_embeds"] = frontend.vision_embeddings(
            key, batch, n_img, cfg.d_model, dtype)
        extras["image_positions"] = frontend.image_positions(batch, n_img, seq)
    return extras
