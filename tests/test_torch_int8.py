"""The port's int8 gradient codec (ops/reference.py, ops/kernels.py and
ops/compression.py of pytorch_distributed_nn_tpu_torch) against the JAX
package's Pallas kernels in interpret mode and its jnp quantizer, on the
CPU.

The TPU kernels draw their noise from the chip's generator; in interpret
mode the JAX package feeds them ``jax.random.uniform`` noise instead. The
tests rebuild that noise as ``pallas_kernels.py`` builds it and hand the
same u to the port's plain versions: q must then be equal bit for bit
(one f32 division, one f32 add and a floor on each side). The port's own
noise, Philox4x32-10, is held to its published known answers and to a
Python-integer Philox. Unbiasedness: the mean of q * scale - x over n
elements lies within 4 standard errors of 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_distributed_nn_tpu.ops import compression as jax_compression
from pytorch_distributed_nn_tpu.ops.pallas_kernels import (
    _QUANT_CHUNK,
    dequantize_int8 as jax_dequantize_int8,
    quantize_int8 as jax_quantize_int8,
    quantize_int8_scaled as jax_quantize_int8_scaled,
)
from pytorch_distributed_nn_tpu_torch.ops import compression, kernels, reference

import torch_cpu  # noqa: F401  (one intra-op thread)

_M = (0xD2511F53, 0xCD9E8D57)
_W = (0x9E3779B9, 0xBB67AE85)


def _philox_py(ctr, key):
    c, k = list(ctr), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + _W[0]) & 0xFFFFFFFF, (k[1] + _W[1]) & 0xFFFFFFFF]
        p0, p1 = _M[0] * c[0], _M[1] * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answers(ctr, key, want):
    got = [int(w) for w in reference.philox4x32(ctr, key)]
    assert got == list(want)
    assert _philox_py(ctr, key) == list(want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 0xDEADBEEF])
def test_philox_uniform_is_the_kernels_stream(seed):
    n = 4 * 9 + 3  # a ragged last quad
    u = reference.philox_uniform(seed, n).numpy()
    want = []
    for t in range(-(-n // 4)):
        want += _philox_py((t, 0, 0, 0), (seed & 0xFFFFFFFF, 0))
    want = np.asarray([(w >> 8) / float(1 << 24) for w in want[:n]],
                      np.float32)
    np.testing.assert_array_equal(u, want)
    assert u.dtype == np.float32 and ((0 <= u) & (u < 1)).all()


def _jax_scaled_noise(seed, n):
    """The noise ``quantize_int8_scaled`` draws in interpret mode: uniform
    over its (padded) grid array, flattened and cut to n."""
    if n <= _QUANT_CHUNK:
        shape = (1, n)
    else:
        chunks = -(-n // _QUANT_CHUNK)
        shape = (chunks * 8, _QUANT_CHUNK // 8)
    u = jax.random.uniform(jax.random.PRNGKey(seed), shape)
    return np.array(u).reshape(-1)[:n]


def _grad_like(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(n) * rng.uniform(0.1, 3.0)).astype(np.float32)


@pytest.mark.parametrize("n", [1, 1000, 16383, 16384, 131072, 131073, 300000])
def test_quantize_int8_scaled_plain_equals_pallas_bitwise(n):
    seed = 1234 + n
    x = _grad_like(n, n)
    scale = np.float32(np.abs(x).max() / 127.0)
    want = np.asarray(jax_quantize_int8_scaled(
        jnp.asarray(x).reshape(1, -1), seed, scale)).reshape(-1)
    u = torch.from_numpy(_jax_scaled_noise(seed, n))
    got = reference.quantize_int8_scaled(torch.from_numpy(x),
                                         torch.tensor(scale), u=u)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64, 256), (7, 1000), (1, 5), (1, 1)])
def test_quantize_int8_plain_equals_pallas_bitwise(shape):
    seed = shape[0] * 31 + shape[1]
    x = _grad_like(int(np.prod(shape)), seed).reshape(shape)
    q_j, s_j = jax_quantize_int8(jnp.asarray(x), seed)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    q, s = reference.quantize_int8(torch.from_numpy(x),
                                   u=torch.from_numpy(u))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    assert s.item() == float(s_j) and s.dtype == torch.float32


@pytest.mark.parametrize("case", range(12))
def test_quantize_int8_scale_equals_pallas_at_many_magnitudes(case):
    """The own scale is XLA's ``amax * f32(1/127)``, not a true division:
    about 1 in 20 amax values tell the two apart."""
    rng = np.random.RandomState(100 + case)
    x = (rng.randn(4, 8) * rng.uniform(0.1, 5.0)).astype(np.float32)
    q_j, s_j = jax_quantize_int8(jnp.asarray(x), case)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(case), (4, 8)))
    q, s = reference.quantize_int8(torch.from_numpy(x), u=torch.from_numpy(u))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    assert s.item() == float(s_j)


def test_scale_is_the_xla_product_with_the_f32_reciprocal():
    a = np.random.RandomState(0).uniform(0.01, 10.0, 20000).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.where(v > 0, v / 127.0, 1.0))(a))
    got = (torch.from_numpy(a) * reference.RECIP127).numpy()
    np.testing.assert_array_equal(got, want)
    assert (a / np.float32(127.0) != want).any()  # a division would differ


def test_quantize_int8_of_zeros_has_scale_one():
    q, s = reference.quantize_int8(torch.zeros(3, 4), seed=0)
    assert s.item() == 1.0 and not q.any()


def test_quantize_int8_of_zeros_equals_pallas():
    x = np.zeros((5, 6), np.float32)
    q_j, s_j = jax_quantize_int8(jnp.asarray(x), 4)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(4), x.shape))
    q, s = reference.quantize_int8(torch.from_numpy(x), u=torch.from_numpy(u))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    assert s.item() == float(s_j) == 1.0


@pytest.mark.parametrize("shape", [(64, 256), (3, 7)])
def test_dequantize_int8_plain_equals_pallas(shape):
    rng = np.random.RandomState(3)
    q = rng.randint(-127, 128, size=shape).astype(np.int8)
    scale = np.float32(0.0123)
    want = np.asarray(jax_dequantize_int8(jnp.asarray(q), scale))
    got = reference.dequantize_int8(torch.from_numpy(q), torch.tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [100, 5000])
def test_small_leaf_formula_equals_jnp_quantizer(n):
    g = _grad_like(n, n + 1)
    key = jax.random.PRNGKey(n)
    amax = np.float32(np.abs(g).max())
    want = jax_compression._int8_quantize_leaf(
        jnp.asarray(g), key, jnp.float32(amax), allow_pallas=False)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n,),
                                                     jnp.float32)))
    got = compression.quantize_small_leaf(torch.from_numpy(g),
                                          torch.tensor(amax), u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("quantize", ["scaled", "own", "small"])
def test_stochastic_rounding_is_unbiased(quantize):
    n = 200_000
    x = torch.from_numpy(_grad_like(n, 5))
    amax = x.abs().amax()
    scale = amax / 127.0
    if quantize == "scaled":
        q = reference.quantize_int8_scaled(x, scale, seed=11)
    elif quantize == "own":
        q, scale = reference.quantize_int8(x, seed=11)
    else:
        q = compression.quantize_small_leaf(
            x, amax, compression.leaf_noise(x.shape, 11, "cpu"))
    err = q.float() * scale - x
    assert err.abs().max().item() <= scale.item() * 1.0001
    # each error is uniform-like within one step: sd <= scale / 2
    bound = 4 * (scale.item() / 2) / np.sqrt(n)
    assert abs(err.mean().item()) < bound


def test_wrappers_on_cpu_tensors_take_the_plain_versions():
    """A CPU tensor goes to the plain version, launches nothing, and
    another seed gives other noise."""
    x = torch.from_numpy(_grad_like(50_000, 9))
    scale = x.abs().amax() / 127.0
    before = kernels.launch_counts()
    q1 = kernels.quantize_int8_scaled(x, scale, 1)
    q2 = kernels.quantize_int8_scaled(x, scale, 2)
    assert torch.equal(q1, reference.quantize_int8_scaled(x, scale, seed=1))
    assert not torch.equal(q1, q2)
    q, s = kernels.quantize_int8(x.reshape(500, 100), 3)
    assert torch.equal(kernels.dequantize_int8(q, s),
                       reference.dequantize_int8(q, s))
    assert kernels.launch_counts() == before


def test_quantize_leaf_dispatches_by_size_as_the_jax_package():
    """Every leaf of at least 16384 elements goes to the grouped quantizer,
    all of them in one call; the smaller ones take the small-leaf formula."""
    big = torch.from_numpy(_grad_like(compression.QUANT_KERNEL_MIN_SIZE, 1))
    small = big[:-1].clone()
    calls = []

    def spy(xs, scales, seeds):
        calls.append([x.numel() for x in xs])
        return reference.quantize_int8_scaled_group(xs, scales, seeds)

    leaves = [small, big, small, big * 2]
    amax = torch.stack([g.abs().amax() for g in leaves])
    qs = compression.quantize_leaves(leaves, [5, 6, 7, 8], amax, spy)
    assert calls == [[compression.QUANT_KERNEL_MIN_SIZE] * 2]
    assert [q.shape for q in qs] == [g.shape for g in leaves]
    assert torch.equal(qs[3], reference.quantize_int8_scaled(
        leaves[3], amax[3] * reference.RECIP127, seed=8))
    assert torch.equal(qs[0], compression.quantize_small_leaf(
        small, amax[0], compression.leaf_noise(small.shape, 5, "cpu")))
    assert jax_compression._PALLAS_QUANT_MIN_SIZE \
        == compression.QUANT_KERNEL_MIN_SIZE


def test_int8_psum_mean_single_contributor_equals_jax_bitwise():
    """group=None (the JAX axis_name=None mode) on scale-exact gradients:
    integers with max |g| = 127, so scale = 1 and q = g whatever the
    noise, in both the kernel-sized and the small leaf."""
    rng = np.random.RandomState(0)
    leaves = []
    for n in (20000, 300):
        g = rng.randint(-127, 128, size=n).astype(np.float32)
        g[n // 2] = -127.0
        leaves.append(g)
    want = jax_compression.int8_psum_mean(
        [jnp.asarray(g) for g in leaves], jax.random.PRNGKey(0), None)
    got = compression.int8_psum_mean([torch.from_numpy(g) for g in leaves],
                                     123, None)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("sizes", [(16384,), (16384, 40000, 131073),
                                   (1, 3, 20000)])
def test_quantize_int8_scaled_group_plain_equals_pallas_bitwise(sizes):
    """The plain grouped quantize is the Pallas ``quantize_int8_scaled``
    leaf by leaf, each leaf with its own scale and the noise its own call
    draws in interpret mode."""
    xs, scales, us, want = [], [], [], []
    for i, n in enumerate(sizes):
        seed = 77 + 13 * i + n
        x = _grad_like(n, seed)
        scale = np.float32(np.abs(x).max() / 127.0)
        want.append(np.asarray(jax_quantize_int8_scaled(
            jnp.asarray(x).reshape(1, -1), seed, scale)).reshape(-1))
        xs.append(torch.from_numpy(x))
        scales.append(scale)
        us.append(torch.from_numpy(_jax_scaled_noise(seed, n)))
    got = reference.quantize_int8_scaled_group(
        xs, torch.tensor(np.asarray(scales)), us=us)
    assert len(got) == len(sizes)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), w)


def test_quantize_int8_scaled_group_wrapper_on_cpu_is_the_plain_group():
    """On CPU tensors the grouped wrapper is the plain group (a leaf per
    seed, scales as a vector or one value each), launches nothing, and
    an empty group gives an empty list."""
    xs = [torch.from_numpy(_grad_like(n, n)) for n in (5, 16384, 70000)]
    scales = torch.stack([x.abs().amax() / 127.0 for x in xs])
    before = kernels.launch_counts()
    got = kernels.quantize_int8_scaled_group(xs, scales, [1, 2, 3])
    for x, s, k, q in zip(xs, scales, (1, 2, 3), got):
        assert torch.equal(q, reference.quantize_int8_scaled(x, s, seed=k))
    again = kernels.quantize_int8_scaled_group(xs, list(scales), [1, 2, 3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert kernels.quantize_int8_scaled_group([], [], []) == []
    with pytest.raises(ValueError):
        kernels.quantize_int8_scaled_group(xs, scales, [1, 2])
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("sizes", [(20000, 300, 16384, 7, 50000),
                                   (300, 20000)])
def test_int8_psum_mean_stacked_amax_single_contributor_equals_jax_bitwise(
        sizes):
    """The port reduces every leaf's amax as one vector and quantizes the
    large leaves in one grouped call; with one contributor (no collective)
    it still equals the JAX per-leaf sync bit for bit on scale-exact
    gradients (an all-zero leaf included, whose scale is 0)."""
    rng = np.random.RandomState(len(sizes))
    leaves = []
    for n in sizes:
        g = rng.randint(-127, 128, size=n).astype(np.float32)
        g[n // 2] = 127.0
        leaves.append(g)
    leaves.append(np.zeros(16384, np.float32))
    want = jax_compression.int8_psum_mean(
        [jnp.asarray(g) for g in leaves], jax.random.PRNGKey(1), None)
    got = compression.int8_psum_mean([torch.from_numpy(g) for g in leaves],
                                     9, None)
    assert len(got) == len(leaves)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
