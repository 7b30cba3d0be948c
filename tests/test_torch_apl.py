"""The port's APL (morphganformer_tpu_torch/apl/) against the JAX package's
on the CPU, one counterpart for each case of tests/test_apl.py: the ring
buffer with wraparound, the refused oversize write, kNN, the early-episode
blank slots, a whole episode of writes and reads, the decoder's logits and
gradients (the same params carried by `from_flax`, within 1e-5 of the
largest entry), the toy episodic task trained in both, and the Encoder in
training and evaluation mode with its updated batch statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from morphganformer_tpu import apl as japl
from morphganformer_tpu_torch import apl

from .test_torch_kernels_cuda import one_torch_thread  # noqa: F401  (a fixture)

TOL = 1e-5


def close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def t(x, dtype=None):
    x = torch.from_numpy(np.array(x))
    return x if dtype is None else x.to(dtype)


def assert_same_state(tstate, jstate):
    np.testing.assert_array_equal(tstate.embeds.numpy(), np.asarray(jstate.embeds))
    np.testing.assert_array_equal(tstate.labels.numpy(), np.asarray(jstate.labels))
    assert int(tstate.write_pointer) == int(jstate.write_pointer)
    assert int(tstate.added) == int(jstate.added)
    assert int(apl.num_entries(tstate)) == int(japl.num_entries(jstate))


def test_ring_buffer_matches_jax():
    size, dim = 7, 3
    ts, js = apl.init_memory(size, dim, 5, device="cpu"), japl.init_memory(size, dim, 5)
    rng = np.random.RandomState(0)
    for batch in [3, 4, 5, 1, 6]:                 # plain, exact fit, wraparound, single
        e = rng.randn(batch, dim).astype(np.float32)
        lab = rng.randint(0, 5, size=batch)
        ts = apl.add_entries(ts, t(e), t(lab))
        js = japl.add_entries(js, jnp.asarray(e), jnp.asarray(lab))
        assert_same_state(ts, js)
    assert int(apl.num_entries(ts)) == size
    blank = apl.flush(ts, 5)
    assert_same_state(blank, japl.flush(js, 5))


def test_write_larger_than_memory_refused_as_in_jax():
    with pytest.raises(ValueError, match="cannot write 5 entries into a 4-slot memory"):
        apl.add_entries(apl.init_memory(4, 2, 3, device="cpu"), torch.zeros((5, 2)),
                        torch.zeros(5, dtype=torch.int32))
    with pytest.raises(ValueError, match="cannot write 5 entries into a 4-slot memory"):
        japl.add_entries(japl.init_memory(4, 2, 3), jnp.zeros((5, 2)), jnp.zeros(5, jnp.int32))


def test_knn_matches_jax():
    rng = np.random.RandomState(1)
    size, dim, k = 16, 4, 5
    embeds = rng.randn(size, dim).astype(np.float32)
    labels = rng.randint(0, 9, size=size)
    queries = rng.randn(3, dim).astype(np.float32)
    ts = apl.add_entries(apl.init_memory(size, dim, 9, device="cpu"), t(embeds), t(labels))
    js = japl.add_entries(japl.init_memory(size, dim, 9), jnp.asarray(embeds),
                          jnp.asarray(labels))
    te, tl, td = apl.nearest_entries(ts, t(queries), k)
    je, jl, jd = japl.nearest_entries(js, jnp.asarray(queries), k)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    close(td.numpy(), jd, what="distances")


def test_early_episode_blank_slots_match_jax():
    """Two real entries, four neighbours asked: two blank slots (label
    n_classes, distance ||q||^2) come back, the same ones as JAX's."""
    ts = apl.add_entries(apl.init_memory(8, 2, 4, device="cpu"), torch.ones((2, 2)),
                         torch.tensor([1, 2], dtype=torch.int32))
    js = japl.add_entries(japl.init_memory(8, 2, 4), jnp.ones((2, 2)),
                          jnp.asarray([1, 2], jnp.int32))
    for q in (np.zeros((1, 2), np.float32), np.asarray([[0.3, -2.0]], np.float32)):
        te, tl, td = apl.nearest_entries(ts, t(q), 4)
        je, jl, jd = japl.nearest_entries(js, jnp.asarray(q), 4)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        close(td.numpy(), jd, what="distances")
        assert (tl.numpy() == 4).sum() == 2


def test_episode_matches_jax_scan():
    """Writes and reads every step, as JAX's jitted lax.scan episode."""
    size, dim, k, steps, batch, classes = 12, 3, 4, 6, 2, 5
    e = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (steps, batch, dim)))
    lab = np.tile(np.asarray([0, 1], np.int32), (steps, 1))
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (steps, 1, dim)))

    @jax.jit
    def episode(es, ls, qs):
        def step(state, inp):
            state = japl.add_entries(state, inp[0], inp[1])
            _, nl, nd = japl.nearest_entries(state, inp[2], k)
            return state, (nl, nd)
        return jax.lax.scan(step, japl.init_memory(size, dim, classes), (es, ls, qs))

    jstate, (jl, jd) = episode(jnp.asarray(e), jnp.asarray(lab), jnp.asarray(q))
    state = apl.init_memory(size, dim, classes, device="cpu")
    for s in range(steps):
        state = apl.add_entries(state, t(e[s]), t(lab[s]))
        _, nl, nd = apl.nearest_entries(state, t(q[s]), k)
        np.testing.assert_array_equal(nl.numpy(), np.asarray(jl[s]))
        close(nd.numpy(), jd[s], what=f"step {s}")
    assert_same_state(state, jstate)


def _decoders(seed=3):
    kw = dict(n_classes=2, query_embed_dim=8, label_embed_dim=8, n_neighbours=4, key_size=4,
              value_size=4, n_heads=2, num_layers=1)
    return japl.RSAFFDecoder(**kw), kw


def _decoder_inputs():
    be = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (3, 4, 8)))
    bl = np.asarray([[0, 1, 2, 1], [1, 1, 0, 2], [2, 0, 0, 1]], np.int32)
    q = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (3, 8)))
    d = np.abs(np.asarray(jax.random.normal(jax.random.PRNGKey(2), (3, 4))))
    return be, bl, q, d


def _flat(tree, prefix=""):
    for key, v in tree.items():
        if hasattr(v, "items"):
            yield from _flat(v, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", v


def test_decoder_logits_and_gradients_match_jax():
    jdec, kw = _decoders()
    be, bl, q, d = _decoder_inputs()
    params = jdec.init(jax.random.PRNGKey(3), be, bl, q, d)
    dec = apl.from_flax(apl.RSAFFDecoder(**kw, generator=torch.Generator().manual_seed(0),
                                         device="cpu"), params)
    got = dec(t(be), t(bl), t(q), t(d))
    close(got.detach().numpy(), jax.jit(jdec.apply)(params, be, bl, q, d), what="logits")

    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jdec.apply(p, be, bl, q, d) ** 2)))(params)
    (got ** 2).mean().backward()
    names = dict(dec.named_parameters())
    flat = dict(_flat(jgrads["params"]))
    assert sorted(flat) == sorted(names)
    for name, g in flat.items():
        close(names[name].grad.numpy(), g, what=name)
    assert any(float(np.abs(np.asarray(g)).max()) > 0 for g in flat.values())


def test_decoder_learns_toy_episodic_task_as_jax():
    """Two clusters in memory; both decoders, from the same init, trained
    with Adam (3e-3) on the same queries: the first steps' losses agree,
    and the port's reaches JAX's criteria (loss below 0.3 of the first,
    accuracy at least 0.9)."""
    rng = np.random.RandomState(0)
    dim, k, n_mem = 8, 4, 16
    centers = np.stack([np.full(dim, 2.0), np.full(dim, -2.0)]).astype(np.float32)

    def sample(n):
        y = rng.randint(0, 2, size=n)
        return (centers[y] + 0.3 * rng.randn(n, dim).astype(np.float32)), y.astype(np.int32)

    mem_x, mem_y = sample(n_mem)
    qx, qy = sample(32)
    tx, ty = sample(64)
    jdec, kw = _decoders()
    js = japl.add_entries(japl.init_memory(n_mem, dim, 2), jnp.asarray(mem_x), jnp.asarray(mem_y))
    ts = apl.add_entries(apl.init_memory(n_mem, dim, 2, device="cpu"), t(mem_x), t(mem_y))
    be, bl, bd = japl.nearest_entries(js, jnp.asarray(qx), k)
    params = jdec.init(jax.random.PRNGKey(0), be, bl, qx, bd)
    dec = apl.from_flax(apl.RSAFFDecoder(**kw, generator=torch.Generator().manual_seed(0),
                                         device="cpu"), params)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def jstep(p, o):
        def loss_fn(p):
            logits = jdec.apply(p, be, bl, qx, bd)
            return optax.softmax_cross_entropy_with_integer_labels(logits, qy).mean()
        loss, grads = jax.value_and_grad(loss_fn)(p)
        updates, o = opt.update(grads, o)
        return optax.apply_updates(p, updates), o, loss

    tadam = torch.optim.Adam(dec.parameters(), lr=3e-3)
    tbe, tbl, tbd = apl.nearest_entries(ts, t(qx), k)
    tlosses, jlosses = [], []
    for _ in range(120):
        loss = torch.nn.functional.cross_entropy(dec(tbe, tbl, t(qx), tbd), t(qy).long())
        tadam.zero_grad()
        loss.backward()
        tadam.step()
        tlosses.append(loss.item())
        params, opt_state, jloss = jstep(params, opt_state)
        jlosses.append(float(jloss))
    close(tlosses[:5], jlosses[:5], tol=1e-4, what="first losses")
    assert tlosses[-1] < 0.3 * tlosses[0], (tlosses[0], tlosses[-1])
    be2, bl2, bd2 = apl.nearest_entries(ts, t(tx), k)
    with torch.no_grad():
        acc = float((dec(be2, bl2, t(tx), bd2).argmax(-1).numpy() == ty).mean())
    assert acc >= 0.9, acc


@pytest.mark.parametrize("embed_dim", [None, 32])
def test_encoder_matches_jax_in_train_and_eval(embed_dim):
    """The same params and batch statistics: the eval-mode output against
    JAX's within 1e-5; the train-mode output and the updated running
    statistics against the port's own float64, within 1e-5, and JAX's
    beside it. In training the last blocks normalise two samples of one
    pixel each, whose variance float32 resolves to about 2e-5 of the
    output in JAX (against float64) and to 6e-6 in the port, so the two
    float32 results are held to float64 rather than to each other."""
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, 32, 32, 1)))
    jenc = japl.Encoder(embed_dim=embed_dim)
    variables = jenc.init(jax.random.PRNGKey(0), x, train=False)
    # Non-trivial running statistics, so that eval mode reads them.
    stats = jax.tree_util.tree_map(lambda v: v + 0.1, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}

    def port(dtype):
        enc = apl.from_flax(apl.Encoder((32, 32, 1), torch.Generator().manual_seed(0),
                                        embed_dim=embed_dim, device="cpu"), variables)
        return enc.to(dtype)

    enc = port(torch.float32)
    out = enc(t(x), train=False)
    assert out.shape == (2, embed_dim or 64)
    close(out.detach().numpy(), jenc.apply(variables, x, train=False), what="eval")

    jout, mutated = jenc.apply(variables, x, train=True, mutable=["batch_stats"])
    enc64 = port(torch.float64)
    ref = enc64(t(x, torch.float64), train=True).detach().numpy()
    close(enc(t(x), train=True).detach().numpy(), ref, what="train")
    close(jout, ref, tol=1e-4, what="JAX's train")
    buffers, buffers64 = dict(enc.named_buffers()), dict(enc64.named_buffers())
    flat = dict(_flat(mutated["batch_stats"]))
    assert sorted(flat) == sorted(buffers)
    for name, v in flat.items():
        close(buffers[name].numpy(), buffers64[name].numpy(), what=name)
        close(v, buffers64[name].numpy(), tol=1e-4, what=f"JAX's {name}")
