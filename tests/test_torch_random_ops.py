"""The port's random ops and random creators, held in distribution.

The port's streams (torch generators, core/random.py) cannot match
JAX's threefry draws, so nothing here compares values with the JAX
package. Each op draws N = 20000 values (rows of a batch for the
categorical ops) and must pass, at p > 1e-3:
- a Kolmogorov-Smirnov test against its continuous law (scipy.stats),
  or a chi-square test of its counts against its discrete law;
- and, where the law has them in closed form, its mean within 5
  standard errors.
Draws repeat under `paddle.seed`, and no op touches torch's global
generator (its state is the same before and after every draw).
"""
import numpy as np
import pytest
import torch
from scipy import stats

import paddle_tpu_torch as paddle
from paddle_tpu_torch.ops import creation, random_ops

N = 20000
P_MIN = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _cpu_device():
    from paddle_tpu_torch.core import place
    prev = place._default
    paddle.set_device("cpu")
    paddle.seed(2024)
    yield
    place._default = prev


def _ks(x, dist):
    assert stats.kstest(np.asarray(x, np.float64).ravel(), dist.cdf).pvalue \
        > P_MIN


def _chi2(counts, probs):
    counts = np.asarray(counts, np.float64)
    probs = np.asarray(probs, np.float64)
    exp = probs / probs.sum() * counts.sum()
    assert stats.chisquare(counts, exp).pvalue > P_MIN


def _mean(x, mu, sd):
    x = np.asarray(x, np.float64).ravel()
    assert abs(x.mean() - mu) < 5 * sd / np.sqrt(x.size), (x.mean(), mu)


# name -> (draw(), the law it follows)
CONTINUOUS = {
    "uniform": (lambda: paddle.uniform([N], min=-2.0, max=3.0),
                stats.uniform(-2.0, 5.0)),
    "rand": (lambda: paddle.rand([N]), stats.uniform(0, 1)),
    "rand_like": (lambda: paddle.rand_like(paddle.zeros([N])),
                  stats.uniform(0, 1)),
    "normal": (lambda: paddle.normal(1.5, 2.0, [N]), stats.norm(1.5, 2.0)),
    "normal_tensor_mean": (lambda: paddle.normal(
        paddle.full([N], 1.5), 2.0), stats.norm(1.5, 2.0)),
    "gaussian": (lambda: paddle.gaussian([N], -1.0, 0.5),
                 stats.norm(-1.0, 0.5)),
    "standard_normal": (lambda: paddle.standard_normal([N]), stats.norm()),
    "randn": (lambda: paddle.randn([N]), stats.norm()),
    "randn_like": (lambda: paddle.randn_like(paddle.zeros([N])),
                   stats.norm()),
    "normal_like": (lambda: random_ops.normal_like(paddle.zeros([N]), 1.0,
                                                   3.0), stats.norm(1, 3)),
    "truncated_normal": (lambda: random_ops.truncated_normal([N], 0.5, 2.0),
                         stats.truncnorm(-2, 2, loc=0.5, scale=2.0)),
    "exponential_": (lambda: random_ops.exponential_(paddle.zeros([N]), 2.5),
                     stats.expon(scale=1 / 2.5)),
    "standard_gamma": (lambda: random_ops.standard_gamma(
        paddle.full([N], 2.5)), stats.gamma(2.5)),
    "standard_gamma_below_1": (lambda: random_ops.standard_gamma(
        paddle.full([N], 0.4)), stats.gamma(0.4)),
    "uniform_": (lambda: paddle.zeros([N]).uniform_(-1.0, 1.0),
                 stats.uniform(-1, 2)),
    "normal_": (lambda: paddle.zeros([N]).normal_(2.0, 0.5),
                stats.norm(2.0, 0.5)),
    "gaussian_random_batch_size_like": (
        lambda: creation.gaussian_random_batch_size_like(
            paddle.zeros([N, 2]), [1, 1], 0.0, 1.0), stats.norm()),
    "uniform_random_batch_size_like": (
        lambda: creation.uniform_random_batch_size_like(
            paddle.zeros([N, 2]), [1, 1]), stats.uniform(-1, 2)),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_draw_follows_its_law(name):
    draw, dist = CONTINUOUS[name]
    x = draw().numpy()
    assert np.isfinite(x).all()
    _ks(x, dist)
    _mean(x, dist.mean(), dist.std())


def test_bernoulli_mean():
    p = 0.3
    x = random_ops.bernoulli(paddle.full([N], p)).numpy()
    assert set(np.unique(x)) <= {0.0, 1.0}
    _chi2([np.sum(x == 0), np.sum(x == 1)], [1 - p, p])


def test_poisson_counts():
    lam = 4.0
    x = random_ops.poisson(paddle.full([N], lam)).numpy().astype(int)
    k = np.arange(12)
    counts = [np.sum(x == v) for v in k] + [np.sum(x >= 12)]
    probs = list(stats.poisson(lam).pmf(k)) + [stats.poisson(lam).sf(11)]
    _chi2(counts, probs)


def test_multinomial_with_replacement_counts():
    probs = np.array([0.5, 0.2, 0.2, 0.1], np.float32)
    x = random_ops.multinomial(paddle.to_tensor(probs * 3), N, True).numpy()
    _chi2(np.bincount(x, minlength=4), probs)
    rows = random_ops.multinomial(paddle.to_tensor(np.eye(3, dtype=np.float32)),
                                  50, True).numpy()
    np.testing.assert_array_equal(rows, np.repeat(np.arange(3)[:, None], 50, 1))


def test_multinomial_without_replacement_is_a_permutation():
    x = random_ops.multinomial(paddle.ones([200, 5]), 5, False).numpy()
    assert (np.sort(x, 1) == np.arange(5)).all()
    # the first draw is uniform over the categories
    _chi2(np.bincount(x[:, 0], minlength=5), np.full(5, 0.2))


def test_sampling_id_counts():
    probs = np.array([0.1, 0.6, 0.3], np.float32)
    x = random_ops.sampling_id(paddle.to_tensor(np.tile(probs, (N, 1)))).numpy()
    assert x.shape == (N,) and x.dtype == np.int64
    _chi2(np.bincount(x, minlength=3), probs)


def test_dirichlet_means_and_sums():
    alpha = np.array([1.0, 2.0, 3.0], np.float32)
    d = random_ops.dirichlet(paddle.to_tensor(np.tile(alpha, (N, 1)))).numpy()
    np.testing.assert_allclose(d.sum(-1), np.ones(N), rtol=1e-5)
    a0 = alpha.sum()
    for j in range(3):
        m = alpha[j] / a0
        sd = np.sqrt(m * (1 - m) / (a0 + 1))
        _mean(d[:, j], m, sd)
    _ks(d[:, 0], stats.beta(alpha[0], a0 - alpha[0]))


def test_randint_counts():
    x = paddle.randint(-3, 4, [N]).numpy()
    assert x.dtype == np.int64 and x.min() >= -3 and x.max() < 4
    _chi2(np.bincount(x + 3, minlength=7), np.full(7, 1 / 7))
    y = paddle.randint_like(paddle.zeros([N], dtype="int32"), 0, 5).numpy()
    assert y.dtype == np.int32
    _chi2(np.bincount(y, minlength=5), np.full(5, 0.2))


def test_randperm_is_uniform_over_positions():
    perms = np.stack([paddle.randperm(6).numpy() for _ in range(600)])
    assert (np.sort(perms, 1) == np.arange(6)).all()
    _chi2(np.bincount(perms[:, 0], minlength=6), np.full(6, 1 / 6))


DRAWS = {
    "uniform": lambda: paddle.uniform([64]),
    "normal": lambda: paddle.normal(0.0, 1.0, [64]),
    "randint": lambda: paddle.randint(0, 100, [64]),
    "randperm": lambda: paddle.randperm(64),
    "bernoulli": lambda: random_ops.bernoulli(paddle.full([64], 0.5)),
    "multinomial": lambda: random_ops.multinomial(paddle.ones([4, 16]), 8),
    "poisson": lambda: random_ops.poisson(paddle.full([64], 3.0)),
    "exponential_": lambda: random_ops.exponential_(paddle.zeros([64])),
    "standard_gamma": lambda: random_ops.standard_gamma(paddle.ones([64])),
    "dirichlet": lambda: random_ops.dirichlet(paddle.ones([8, 4])),
    "sampling_id": lambda: random_ops.sampling_id(paddle.ones([8, 4])),
    "truncated_normal": lambda: random_ops.truncated_normal([64]),
    "normal_like": lambda: random_ops.normal_like(paddle.zeros([64])),
    "uniform_": lambda: paddle.zeros([64]).uniform_(),
    "normal_": lambda: paddle.zeros([64]).normal_(),
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_draws_repeat_under_seed_and_leave_torch_global_alone(name):
    """paddle.seed(s) repeats the draw; torch's global generator is not
    touched (its state is the same before and after)."""
    draw = DRAWS[name]
    paddle.seed(7)
    before = torch.get_rng_state()
    a = draw().numpy()
    assert torch.equal(torch.get_rng_state(), before), name
    paddle.seed(7)
    b = draw().numpy()
    np.testing.assert_array_equal(a, b)
    c = draw().numpy()
    assert not np.array_equal(a, c), name
