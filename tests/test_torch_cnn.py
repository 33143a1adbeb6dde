"""The port's CNN zoo and its converter (pytorch_distributed_nn_tpu_torch/
models) against the JAX package's flax models, f32, on the CPU.

Weights come from the flax init and cross through the converter (params
and batch_stats), inputs from numpy with a seed. Logits agree within
1e-4 (measured on the CPU at the tests' seeds: train mode ResNet-18
5.4e-6, ResNet-20 4.5e-6, LeNet 1.3e-6; eval mode ResNet-18 6.9e-7,
VGG-11 2.2e-7, with logits of size 0.4-3; the sums run in another
order); the batch_stats after one train-mode forward within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from pytorch_distributed_nn_tpu.models import build_model as jax_build
from pytorch_distributed_nn_tpu.models import model_names as jax_names
from pytorch_distributed_nn_tpu_torch.models import (
    TEXT_MODELS,
    build_model,
    input_spec,
    model_names,
)
from pytorch_distributed_nn_tpu_torch.models.convert import (
    cnn_to_state_dict,
    state_dict_to_cnn,
)
from pytorch_distributed_nn_tpu_torch.models.layers import BatchNorm, Conv

import torch_cpu  # noqa: F401  (one intra-op thread)

LOGITS_TOL = 1e-4
STATS_TOL = 1e-5


def _init(name, shape, seed=0):
    model = jax_build(name, 10)
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "dropout": jax.random.PRNGKey(seed)},
                   jnp.zeros((1, *shape)), train=False)
    return model, v["params"], v.get("batch_stats", {})


def _randomize_stats(stats, seed):
    """Running means N(0, 0.1^2), variances U(0.5, 1.5): eval-mode
    activations that neither die nor blow up."""
    rng = np.random.RandomState(seed)

    def draw(path, a):
        var = str(getattr(path[-1], "key", path[-1])) == "var"
        v = rng.uniform(0.5, 1.5, a.shape) if var else \
            rng.normal(0.0, 0.1, a.shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, stats)


def _port(name, params, stats):
    m = build_model(name, 10)
    m.load_state_dict(cnn_to_state_dict(params, stats))
    return m


def _images(B, shape, seed=1):
    return np.random.RandomState(seed).randn(B, *shape).astype(np.float32)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _compare_train(name, shape, B):
    model, params, stats = _init(name, shape)
    x = _images(B, shape)
    want, mutated = model.apply({"params": params, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    port = _port(name, params, stats).train()
    got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LOGITS_TOL)
    if stats:
        _, new_stats = state_dict_to_cnn(port.state_dict())
        want_s, got_s = _flat(mutated["batch_stats"]), _flat(new_stats)
        assert want_s.keys() == got_s.keys()
        for k in want_s:
            np.testing.assert_allclose(got_s[k], want_s[k], rtol=0,
                                       atol=STATS_TOL, err_msg=k)


def test_resnet18_train_forward_and_batch_stats_match_flax():
    _compare_train("ResNet18", (32, 32, 3), 2)


def test_resnet20_train_forward_and_batch_stats_match_flax():
    _compare_train("ResNet20", (16, 16, 3), 4)


def test_lenet_train_forward_matches_flax():
    _compare_train("LeNet", (28, 28, 1), 3)


@pytest.mark.parametrize("name,shape", [("ResNet18", (32, 32, 3)),
                                        ("VGG11", (32, 32, 3))])
def test_eval_forward_with_running_stats_matches_flax(name, shape):
    model, params, stats = _init(name, shape)
    stats = _randomize_stats(stats, 3)
    x = _images(2, shape)
    want = model.apply({"params": params, "batch_stats": stats},
                       jnp.asarray(x), train=False)
    got = _port(name, params, stats).eval()(torch.from_numpy(x))
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=LOGITS_TOL)


def test_stride2_same_padding_is_asymmetric_as_flax():
    """flax SAME pads a 3x3 stride-2 conv on an even input by (0, 1); the
    port's Conv does too, and nn.Conv2d(padding=1) would not."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 8, 3).astype(np.float32)
    conv = fnn.Conv(5, (3, 3), strides=(2, 2), padding="SAME", use_bias=False)
    p = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(conv.apply(p, jnp.asarray(x)))  # (2, 4, 4, 5)
    port = Conv(3, 5, 3, stride=2, bias=False)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(
            np.array(p["params"]["kernel"]).transpose(3, 2, 0, 1)))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = port(xt).permute(0, 2, 3, 1).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    symmetric = F.conv2d(xt, port.weight, stride=2, padding=1)
    assert np.abs(symmetric.permute(0, 2, 3, 1).detach().numpy()
                  - want).max() > 1e-2


def test_batchnorm_running_variance_is_biased_as_flax():
    """The running variance moves with the biased batch variance, as
    flax's does; F.batch_norm's unbiased update would be n/(n-1) larger."""
    rng = np.random.RandomState(0)
    x = (rng.randn(4, 3, 3, 6) * 2 + 1).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x))
    y, mut = bn.apply(v, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm(6).train()
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), rtol=0, atol=1e-5)
    want_var = np.asarray(mut["batch_stats"]["var"])
    np.testing.assert_allclose(port.running_var.numpy(), want_var, atol=1e-6)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=1e-6)
    rm, rv = torch.zeros(6), torch.ones(6)
    F.batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), rm, rv,
                 training=True, momentum=0.1, eps=1e-5)
    assert np.abs(rv.numpy() - want_var).max() > 1e-3


def test_lenet_flattens_in_nhwc_order():
    """fc1's input rows run over (h, w, c), flax's flatten order: the
    converter transposes the kernel and reorders nothing."""
    _, params, _ = _init("LeNet", (28, 28, 1))
    sd = cnn_to_state_dict(params)
    np.testing.assert_array_equal(sd["fc1.weight"].numpy(),
                                  np.asarray(params["fc1"]["kernel"]).T)


@pytest.mark.parametrize("name,shape", [("ResNet20", (32, 32, 3)),
                                        ("ResNet50", (32, 32, 3)),
                                        ("LeNet", (28, 28, 1)),
                                        ("VGG11", (32, 32, 3)),
                                        ("VGG11NoBN", (32, 32, 3))])
def test_converter_round_trips_exactly(name, shape):
    _, params, stats = _init(name, shape)
    sd = cnn_to_state_dict(params, stats)
    port = build_model(name)
    assert set(sd) == set(port.state_dict())
    for k, t in port.state_dict().items():
        assert sd[k].shape == t.shape, k
    p2, s2 = state_dict_to_cnn(sd)
    for a, b in ((params, p2), (stats, s2)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k])


def test_zoo_has_every_jax_model_with_its_input_spec():
    from pytorch_distributed_nn_tpu.models import input_spec as jax_spec

    assert set(model_names()) == set(jax_names())
    for name in model_names():
        assert tuple(input_spec(name)) == tuple(jax_spec(name)), name
    for name in sorted(set(model_names()) - TEXT_MODELS):
        assert sum(p.numel() for p in build_model(name).parameters()) == sum(
            np.size(v) for v in jax.tree.leaves(
                _init(name, input_spec(name))[1])), name
