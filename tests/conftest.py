"""Test configuration: JAX on the CPU with a virtual 8-device mesh.

Multi-device hardware is not available where the suite runs; sharding
tests use ``xla_force_host_platform_device_count=8`` per the standard JAX
recipe.  Must run before jax is imported anywhere.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu_device``
fixture, which skips them when JAX finds no GPU; on the card they run
in-process from ``chip_smoke.py``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def gpu_device():
    """The first GPU, decided when the test runs (never at import, so
    every xdist worker collects the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform!r}")
    return dev


# ---------------------------------------------------------------------------
# Test tiers.  ``pytest -m smoke`` must deliver a signal in < 5 minutes on a
# CPU host: every pure unit module plus ONE small pipeline config per
# feature.  ``pytest -m full`` runs the complement; no marker filter runs
# everything.

#: Whole modules cheap enough (and unit-y enough) to always smoke.
_SMOKE_MODULES = {
    "test_layout.py", "test_scene.py", "test_geometry.py",
    "test_svg_full.py", "test_native.py", "test_sort.py", "test_keyed.py",
    "test_gatherm.py", "test_evenodd.py", "test_api.py", "test_clips.py",
    "test_fine.py", "test_fine_kernel.py",
}

#: Hand-picked pipeline representatives (one small config per feature).
_SMOKE_TESTS = (
    "test_renderer.py::test_render_matches_golden[tiger_1x]",
    "test_coarse.py::test_coarse_matches_cpu_tiler[tiger_1x_wide_tiles]",
    "test_group_clips.py::test_nested_clips_and_layer_device_matches_oracle",
    "test_gradients.py::test_render_matches_oracle_xla",
    "test_combined_fills.py::test_coarse_commands_match_oracle",
    "test_parallel.py::test_sharded_matches_golden_cardioid",
    "test_capacity.py::test_fitted_render_matches",
    "test_pairing.py::test_pairing_preserves_command_sequence[tiger_1x-compact]",
    "test_expand.py::test_basic_expansion",
)


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.nodeid.split("::", 1)[0].rsplit("/", 1)[-1]
        node = item.nodeid.split("/")[-1]
        if mod in _SMOKE_MODULES or node in _SMOKE_TESTS:
            item.add_marker(pytest.mark.smoke)
        else:
            item.add_marker(pytest.mark.full)
