"""The plain reference is the program's model, and bfloat16 is far from
it."""

import jax
import jax.numpy as jnp
import numpy as np

from qgbench import harness
from qgbench import reference as ref


def small_model(M=32):
    cfg = harness.load_json(harness.BENCH_DIR / "configs" /
                            "turbulence-2048.json")
    return {**cfg["model"], "M": M, "P": M}


def test_reference_equals_the_program_in_float64():
    from tpu_qg.config import ModelConfig
    from tpu_qg.models.core import QGModel, init_state

    m = {**small_model(), "dtype": "float64"}
    with jax.enable_x64(True):
        cfg = ModelConfig(**m)
        s = init_state(cfg, key=jax.random.PRNGKey(3))
        want = QGModel(cfg).run(s, 7)
        got = ref.run(ref.physics(m), tuple(s), 7)
        for i, name in enumerate(("zeta", "psi", "f1", "f2")):
            assert ref.rel_l2(got[i], getattr(want, name)) < 1e-12, name
        assert int(got[4]) == int(want.step) == 7


def test_bfloat16_reference_is_far_from_float64():
    m = small_model()
    ph = ref.physics(m)
    rng = np.random.default_rng(0)
    psi = rng.uniform(size=(2, 32, 32)) * 4000.0
    zeta = np.stack([np.asarray(ref.laplacian(jnp.asarray(p), ph.dx))
                     for p in psi])
    zero = np.zeros_like(psi)
    with jax.enable_x64(True):
        hi = ref.run(ph, ref.from_host([zeta, psi, zero, zero], 0,
                                       jnp.float64), 20)
        lo = ref.run(ph, ref.from_host([zeta, psi, zero, zero], 0,
                                       jnp.bfloat16), 20)
        assert lo[0].dtype == jnp.bfloat16
        assert ref.rel_l2(lo[0], hi[0]) > 1e-3
