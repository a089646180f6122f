import os

# Virtual 8-device CPU mesh for sharding tests (multi-chip is validated on
# a host-platform device mesh; real TPU runs use the same code paths).
# NOTE: this environment may force an accelerator platform via a plugin
# that ignores JAX_PLATFORMS, so also set the config explicitly.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

try:
    import jax

    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass

import pytest  # noqa: E402

REF = "/root/reference/test"


def ref_fixture(name: str) -> str:
    path = os.path.join(REF, name)
    if not os.path.exists(path):
        pytest.skip(f"reference fixture {name} not available")
    return path


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU")
