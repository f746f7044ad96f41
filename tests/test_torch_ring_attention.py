"""The port's ring attention (``parallel/ring_attention.py``) and the
sequence-sharded LM against the JAX package's, from the same
numpy-seeded inputs:

- the plain ring and the flash ring (the kernels' plain versions per
  block on the CPU) over four gloo CPU ranks on a ``seq`` axis of 4,
  causal and not, forward and gradients, against the JAX rings
  (``make_ring_attention``, the Pallas kernel in interpret mode) on four
  of conftest's host devices; and on ``data`` x ``seq`` = 2 x 2;
- the block schedule: rank ``r`` runs ``r + 1`` forward blocks and as
  many backward ones under causal masking, every block otherwise;
- the fully masked merge: weights 0, no NaN, as the reference's;
- the sequence-sharded ``TransformerLM`` (``seq`` 4, and ``data`` 2 x
  ``seq`` 2) through ``make_grad_fn``'s mesh path against the one-device
  flax model: the loss and every gradient.

Tolerances (float32): outputs 1e-5 relative L2, gradients 1e-4; the LM's
loss 1e-5 relative.
"""

import os
import socket

import numpy as np
import pytest
import torch

OUT_TOL = 1e-5
GRAD_TOL = 1e-4
N_RANKS = 4
B, L_LOCAL, H, DH = 2, 8, 2, 16
RING_CASES = {
    # name: (mesh shape, use_flash, causal)
    "plain_causal": ({"seq": 4}, False, True),
    "plain_full": ({"seq": 4}, False, False),
    "flash_causal": ({"seq": 4}, True, True),
    "flash_full": ({"seq": 4}, True, False),
    "data_seq_flash_causal": ({"data": 2, "seq": 2}, True, True),
}
LM_CFG = dict(vocab_size=64, num_layers=2, num_heads=2, head_dim=16,
              embed_dim=32, mlp_dim=64)
LM_MESHES = {"seq4": {"seq": 4}, "data2_seq2": {"data": 2, "seq": 2}}
LM_TOKENS = (4, 32)  # global batch, global length


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def _qkv(name):
    """Global (B_global, L, H, D) q, k, v and an output cotangent."""
    shape, _, _ = RING_CASES[name]
    rng = np.random.default_rng(sorted(RING_CASES).index(name))
    b = B * shape.get("data", 1)
    full = (b, L_LOCAL * shape["seq"], H, DH)
    return [rng.standard_normal(full).astype(np.float32) for _ in range(4)]


def _local(x, mesh, shape):
    if "data" in shape:
        x = np.split(x, shape["data"], axis=0)[mesh.axis("data").index]
    return np.split(x, shape["seq"], axis=1)[mesh.axis("seq").index]


def _lm_tokens(seed=0):
    return np.random.default_rng(seed).integers(
        0, LM_CFG["vocab_size"], LM_TOKENS).astype(np.int32)


# -- the ranks ---------------------------------------------------------------


def _ring_case(name, rank, out_dir):
    from elasticdl_tpu_torch.parallel import ring_attention as ra
    from elasticdl_tpu_torch.parallel.mesh import create_mesh

    shape, use_flash, causal = RING_CASES[name]
    mesh = create_mesh(shape, devices=["cpu"])
    q, k, v, cot = (_local(x, mesh, shape) for x in _qkv(name))
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    blocks = {"fwd": 0, "bwd": 0}
    fwd, bwd = ra._block_fwd, ra._block_bwd

    def count(kind, fn):
        def counted(*args):
            blocks[kind] += 1
            return fn(*args)
        return counted

    ra._block_fwd, ra._block_bwd = count("fwd", fwd), count("bwd", bwd)
    try:
        ring = ra.make_ring_attention(mesh, "seq", causal=causal,
                                      use_flash=use_flash)
        out = ring(qt, kt, vt)
        (out * torch.tensor(cot)).sum().backward()
    finally:
        ra._block_fwd, ra._block_bwd = fwd, bwd
    np.savez(
        os.path.join(out_dir, "%s-%d.npz" % (name, rank)),
        out=out.detach().numpy(), dq=qt.grad.numpy(), dk=kt.grad.numpy(),
        dv=vt.grad.numpy(), fwd_blocks=blocks["fwd"],
        bwd_blocks=blocks["bwd"], seq_index=mesh.axis("seq").index,
    )


def _seq_lm(name, rank, out_dir):
    from elasticdl_tpu_torch.common import convert
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.training.step import make_grad_fn

    shape = LM_MESHES[name]
    mesh = create_mesh(shape, devices=["cpu"])
    model = tzoo.custom_model(mesh=mesh, seq_axis="seq", **LM_CFG)
    named = dict(np.load(os.path.join(out_dir, "lm_init.npz")))
    model.load_state_dict(convert.to_state_dict(named))
    tokens = _lm_tokens()
    loss, grads, _, output = make_grad_fn(
        model, tzoo.loss, mesh=mesh, seq_axis="seq")(
        dict(model.named_parameters()), dict(model.named_buffers()),
        {"tokens": tokens}, tokens,
    )
    np.savez(
        os.path.join(out_dir, "lm_%s-%d.npz" % (name, rank)),
        loss=loss.numpy(), logits=output.numpy(),
        **{"g/" + n: g.numpy() for n, g in grads.items()},
    )


def _rank_main(rank, port, out_dir):
    torch.distributed.init_process_group(
        "gloo", init_method="tcp://127.0.0.1:%d" % port, rank=rank,
        world_size=N_RANKS,
    )
    try:
        for name in sorted(RING_CASES):
            _ring_case(name, rank, out_dir)
        for name in sorted(LM_MESHES):
            _seq_lm(name, rank, out_dir)
    finally:
        torch.distributed.destroy_process_group()


def _jax_lm():
    import jax

    from elasticdl_tpu.nn.model_api import init_variables
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm = jzoo.custom_model(**LM_CFG)
    params = init_variables(jm, jax.random.PRNGKey(0),
                            {"tokens": _lm_tokens()})["params"]
    return jm, params


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays

    out = tmp_path_factory.mktemp("ring_ranks")
    _, params = _jax_lm()
    np.savez(out / "lm_init.npz", **{
        k: np.asarray(v) for k, v in pytree_to_named_arrays(params).items()})
    mp.spawn(_rank_main, args=(_free_port(), str(out)), nprocs=N_RANKS,
             join=True)
    return out


def _jax_ring(name):
    import jax

    from elasticdl_tpu.parallel.mesh import create_mesh as jmesh
    from elasticdl_tpu.parallel.ring_attention import make_ring_attention

    shape, use_flash, causal = RING_CASES[name]
    q, k, v, cot = _qkv(name)
    mesh = jmesh(shape, axis_names=tuple(shape),
                 devices=jax.devices()[:N_RANKS])
    ring = make_ring_attention(mesh, "seq", causal=causal,
                               use_flash=use_flash)

    def loss(q, k, v):
        return (ring(q, k, v) * cot).sum()

    with mesh:
        out = np.asarray(jax.jit(ring)(q, k, v))
        grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return out, [np.asarray(g) for g in grads]


# -- the rings ---------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(RING_CASES))
def test_ring_over_gloo_ranks_matches_the_jax_ring(name, ranks):
    from elasticdl_tpu_torch.parallel.mesh import Axis

    shape, _, _ = RING_CASES[name]
    out, grads = _jax_ring(name)
    n_seq, n_data = shape["seq"], shape.get("data", 1)
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("%s-%d.npz" % (name, rank))))
        d, s = divmod(rank, n_seq)
        coords = {"data": d, "seq": s}

        class _M:
            def axis(self, a):
                return Axis(a, shape[a], coords[a], (), None)

        def mine(x):
            return _local(x, _M(), shape)

        assert int(got["seq_index"]) == s
        assert _rel(got["out"], mine(out)) < OUT_TOL, rank
        for key, want in zip(("dq", "dk", "dv"), grads):
            assert _rel(got[key], mine(want)) < GRAD_TOL, (rank, key)
    assert n_data * n_seq == N_RANKS


@pytest.mark.parametrize("name", ["flash_causal", "flash_full"])
def test_the_flash_ring_runs_r_plus_one_blocks_on_rank_r_when_causal(
        name, ranks):
    _, _, causal = RING_CASES[name]
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("%s-%d.npz" % (name, rank))))
        want = rank + 1 if causal else N_RANKS
        assert int(got["fwd_blocks"]) == want, rank
        assert int(got["bwd_blocks"]) == want, rank


def test_block_cases_are_the_references():
    from elasticdl_tpu_torch.parallel.ring_attention import _block_cases

    assert _block_cases(0, 2, False) == "full"
    assert _block_cases(2, 2, True) == "diag"
    assert _block_cases(1, 2, True) == "full"
    assert _block_cases(3, 2, True) == "skip"


def test_the_fully_masked_merge_gives_zero_weights_and_no_nan():
    import jax.numpy as jnp

    from elasticdl_tpu.parallel.ring_attention import (
        _merge_normalized as jmerge,
    )
    from elasticdl_tpu_torch.parallel.ring_attention import (
        _merge_normalized,
    )

    rng = np.random.default_rng(0)
    o1 = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    o2 = rng.standard_normal((1, 4, 2, 8)).astype(np.float32)
    lse1 = rng.standard_normal((1, 2, 4)).astype(np.float32)
    lse2 = lse1.copy()
    lse1[0, 0, :2] = -np.inf  # one side empty
    lse1[0, 1, :] = lse2[0, 1, :] = -np.inf  # both sides empty
    o, lse = _merge_normalized(*(torch.tensor(x)
                                 for x in (o1, lse1, o2, lse2)))
    jo, jlse = jmerge(*(jnp.asarray(x) for x in (o1, lse1, o2, lse2)))
    assert not torch.isnan(o).any()
    np.testing.assert_array_equal(o.numpy()[0, :, 1], 0.0)
    np.testing.assert_array_equal(np.isinf(lse.numpy()), np.isinf(jlse))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)


def test_a_ring_on_one_device_is_flash_attention():
    from elasticdl_tpu_torch.ops.flash_attention import (
        plain_flash_with_lse,
    )
    from elasticdl_tpu_torch.parallel.mesh import create_mesh
    from elasticdl_tpu_torch.parallel.ring_attention import (
        make_ring_attention,
    )

    q, k, v, _ = (torch.tensor(x) for x in _qkv("flash_causal"))
    ring = make_ring_attention(create_mesh({"seq": 1}, devices=["cpu"]),
                               "seq", causal=True)
    want, _ = plain_flash_with_lse(q, k, v, True)
    torch.testing.assert_close(ring(q, k, v), want, rtol=1e-6, atol=1e-6)


def test_heads_over_a_model_axis_raise_by_name():
    """Heads over ``model`` run since tensor parallelism is ported
    (tests/test_torch_tensor_parallel.py holds the ring on seq x model
    against the JAX ring); what still raises by name is the LM with
    experts over an ``expert`` axis and a ``model`` axis together."""
    from elasticdl_tpu_torch.model_zoo.transformer_lm import (
        transformer_lm as tzoo,
    )

    class _Mesh:
        axis_names = ("expert", "model")
        shape = {"expert": 2, "model": 2}

    with pytest.raises(NotImplementedError,
                       match="expert.*model.*ROADMAP A9"):
        tzoo.custom_model(mesh=_Mesh(), num_experts=2)


# -- the sequence-sharded LM -------------------------------------------------


@pytest.mark.parametrize("name", sorted(LM_MESHES))
def test_the_seq_sharded_lm_matches_the_one_device_flax_model(name, ranks):
    """Each rank runs its shard (B / data, L / seq) with global rotary
    positions, the ring, and the shifted next-token targets; the step's
    mesh path reduces the loss and gradients. Against the flax model on
    the whole batch on one device."""
    import jax

    from elasticdl_tpu.common.tensor import pytree_to_named_arrays
    from elasticdl_tpu_torch.common import convert
    from model_zoo.transformer_lm import transformer_lm as jzoo

    jm, params = _jax_lm()
    tokens = _lm_tokens()

    def loss_fn(p):
        out = jm.apply({"params": p}, {"tokens": tokens})
        return jzoo.loss(out, tokens), out

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        params)
    grads = convert.to_state_dict(pytree_to_named_arrays(grads))
    shape = LM_MESHES[name]
    n_seq, n_data = shape["seq"], shape.get("data", 1)
    logits = np.asarray(logits)
    for rank in range(N_RANKS):
        got = dict(np.load(ranks / ("lm_%s-%d.npz" % (name, rank))))
        d, s = divmod(rank, n_seq)
        want = np.split(np.split(logits, n_data, 0)[d], n_seq, 1)[s]
        assert _rel(got["logits"], want) < OUT_TOL, rank
        assert abs(float(got["loss"]) - float(loss)) < 1e-5 * float(loss)
        for key, want in grads.items():
            assert _rel(got["g/" + key], want.numpy()) < GRAD_TOL, (rank,
                                                                    key)
