"""The port's stochastic-rounding helpers (``gru4rec_tpu_torch/ops/sr.py``)
against the JAX package's (``gru4rec_tpu/ops/sr.py``).

The hash and the rounding must be bit-equal to JAX's, because the state
they store is compared bit for bit: ``mix32`` and ``sr_bits16`` on random
int32 seeds, rows (negative ones and the int32-max sentinel included) and
column offsets; ``sr_round_bf16`` on random float32 of every sign and
magnitude, and on values bf16 already represents (returned exactly for
every dither). The base-256 limbs round-trip exactly through carries past
256 and 65,536; the rounding is exactly unbiased over all 2^16 dithers;
``step_seed`` is deterministic and distinct across salts and steps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from gru4rec_tpu.ops import sr as jsr  # noqa: E402
from gru4rec_tpu_torch.ops import sr as tsr  # noqa: E402
from gru4rec_tpu_torch.train.step import SR_TABLE_SALT  # noqa: E402


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hash_is_bit_equal_to_jax(seed):
    rng = np.random.RandomState(seed)
    h = rng.randint(-2**31, 2**31 - 1, 4096).astype(np.int32)
    np.testing.assert_array_equal(
        tsr.mix32(torch.from_numpy(h).to(torch.int64)).numpy(),
        np.asarray(jsr.mix32(jnp.asarray(h))).astype(np.int64) & 0xFFFFFFFF)
    for col_offset in (0, 1, 300):
        s = int(rng.randint(-2**31, 2**31 - 1))
        rows = rng.randint(-2**31, 2**31 - 1, 97).astype(np.int32)
        rows[:3] = [np.iinfo(np.int32).max, 0, -1]
        want = np.asarray(jsr.sr_bits16(jnp.int32(s), jnp.asarray(rows), 33,
                                        col_offset=col_offset))
        got = tsr.sr_bits16(s, torch.from_numpy(rows), 33, col_offset=col_offset)
        assert got.dtype == torch.int32 and got.shape == (97, 33)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.min() >= 0 and got.max() < 65536


def test_round_is_bit_equal_to_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(64, 80) * np.exp(rng.randn(64, 80) * 6)).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 1.0, -2.5]  # representable: exact for any dither
    bits = rng.randint(0, 65536, x.shape).astype(np.int32)
    got = tsr.sr_round_bf16(torch.from_numpy(x), torch.from_numpy(bits))
    want = np.asarray(jsr.sr_round_bf16(jnp.asarray(x), jnp.asarray(bits)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), want.view(np.int16))
    np.testing.assert_array_equal(got[0, :4].float().numpy(), x[0, :4])


def test_round_is_unbiased_and_exact_on_representable():
    """The mean over all 2^16 dithers equals the float32 input exactly."""
    rs = torch.arange(65536, dtype=torch.int32)
    for xv in (1.0 + 2**-12, -1.0 - 2**-12, 3.7e-5, -0.124567, 123456.789):
        x = torch.full((65536,), xv, dtype=torch.float32)
        vals = tsr.sr_round_bf16(x, rs).double()
        assert float(vals.mean()) == float(x[0]), xv
    for xv in (0.0, 1.0, -2.5, 0.00390625):
        x = torch.full((4,), xv)
        r = torch.tensor([0, 1, 32767, 65535], dtype=torch.int32)
        assert torch.equal(tsr.sr_round_bf16(x, r).float(), x)


def test_limbs_round_trip_through_carries():
    cnt = torch.tensor([0, 1, 255, 256, 257, 65535, 65536, 65537, 2**24 - 1],
                       dtype=torch.float32)
    lo, mid, hi = tsr.limbs_encode(cnt)
    for limb in (lo, mid, hi):
        assert bool(((limb >= 0) & (limb <= 255) & (limb == limb.floor())).all())
        # each limb is exact in bf16
        assert torch.equal(limb.to(torch.bfloat16).float(), limb)
    assert torch.equal(tsr.limbs_decode(lo, mid, hi), cnt)
    jl = jsr.limbs_encode(jnp.asarray(cnt.numpy()))
    for a, b in zip((lo, mid, hi), jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # +1 carries exactly through both limb boundaries
    nxt = tsr.limbs_decode(*tsr.limbs_encode(cnt)) + 1.0
    assert torch.equal(tsr.limbs_decode(*tsr.limbs_encode(nxt)), cnt + 1.0)


def test_step_seed_is_deterministic_and_distinct():
    seeds = {(salt, step): tsr.step_seed(42, step, salt)
             for salt in SR_TABLE_SALT.values() for step in range(200)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(-2**31 <= v < 2**31 for v in seeds.values())
    assert tsr.step_seed(42, 7, SR_TABLE_SALT["Wy"]) == seeds[(SR_TABLE_SALT["Wy"], 7)]
    assert tsr.step_seed(43, 7, SR_TABLE_SALT["Wy"]) != seeds[(SR_TABLE_SALT["Wy"], 7)]
