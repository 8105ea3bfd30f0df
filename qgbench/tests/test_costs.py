"""The byte/FLOP model and the peak table."""

import math

import jax
import jax.numpy as jnp
import pytest

from qgbench import costmodel as cm
from qgbench import harness
from qgbench import reference as ref


def model(name, **kw):
    cell_config = harness.load_json(
        harness.BENCH_DIR / "configs" / f"{name}.json")
    return {**cell_config["model"], **kw}


def test_stencil_flops_are_xlas_count_of_the_reference():
    m = model("turbulence-2048", M=32, P=32)
    ph = ref.physics(m)

    def tendency_update(z, p, f1, f2):
        t = ref.tendency(ph, z, p)
        ab3 = (23.0 / 12.0) * t - (16.0 / 12.0) * f1 + (5.0 / 12.0) * f2
        return z + ph.dt * ab3, t

    x = jnp.ones((2, 32, 32), jnp.float32)
    cost = jax.jit(tendency_update).lower(x, x, x, x).compile().cost_analysis()
    assert cost["flops"] / (2 * 32 * 32) == cm.STENCIL_FLOPS_PER_LAYER_POINT


def test_one_card_floors_from_shapes():
    c = harness.load_module(harness.BENCH_DIR / "costs" /
                            "turbulence-2048.py").per_step(
        model("turbulence-2048"), 1)
    n = 2048 * 2048
    # zeta, psi, f1, f2 read and zeta, f1 written, two layers, float32.
    assert c["stencil_bytes"] == 6 * 2 * n * 4 == 201_326_592
    # Forward and inverse complex64 transform, each read and written once.
    assert c["fft_bytes"] == 2 * 2 * 8 * n
    assert c["fft_flops"] == 2 * 5 * n * math.log2(n) + 14 * n
    assert c["flops"] == c["stencil_flops"] + c["fft_flops"]
    assert 1.4e9 < c["flops"] < 1.6e9


def test_four_card_floors_split_over_chips():
    costs = harness.load_module(harness.BENCH_DIR / "costs" / "pod-8192.py")
    one, four = (costs.per_step(model("pod-8192"), k) for k in (1, 4))
    n = 8192 * 8192
    assert one["fft_bytes"] == 2 * (4 * n + 8 * n) * 2
    for key in ("stencil_bytes", "fft_bytes", "flops"):
        assert four[key] == pytest.approx(one[key] / 4)


def test_peak_table_is_keyed_by_device_kind():
    path = harness.peak_file("NVIDIA H100 80GB HBM3")
    peaks = harness.load_json(path)
    assert peaks["device_kind"] == "NVIDIA H100 80GB HBM3"
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["float32_flops_per_s"] == 67e12
    assert peaks["float64_flops_per_s"] == 34e12
    assert peaks["nvlink_bytes_per_s_each_way"] == 450e9
    with pytest.raises(FileNotFoundError):
        harness.load_json(harness.peak_file("NVIDIA A100-SXM4-40GB"))
