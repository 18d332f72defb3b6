"""The port's audio family (`repro_torch.models.encdec`) against `repro`, on the CPU.

The reduced seamless-m4t-large-v2 (2 encoder + 2 decoder layers, d 256,
4/4 heads of Dh 64, vocab 512, 16 frames) in float32, and in bfloat16 where
a test says so.  The reference's seed-0 weights (drawn once for the module:
its jitted init and the other XLA compiles are most of this file's time)
cross as numpy (`convert.audio_params_from_numpy`); tokens and frame
embeddings come from numpy seeds.  On the CPU the port's attention is the
plain version of K4, K4b and K5.

Tolerances: F32_TOL of tests/test_torch_models.py (rtol = atol = 1e-4,
summation order only) on logits, losses, gradients, caches and decode
steps; BF16_TOL (5e-2) in bfloat16; greedy tokens equal in float32; int8
trees bit for bit; the training steps tests/test_torch_train.py's
(`deep_step_matches_reference`) and tests/test_torch_optim.py's; the
checkpoint bit for bit.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import deep_step_matches_reference, np_tree, reference_params  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import ShardedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.serve import BatchServer as JaxServer  # noqa: E402
from repro.launch.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro.models import layers as jnn  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.quant import quantize_params as ref_quantize_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    BatchServer,
    ServeConfig,
    make_adamw_train_step,
    make_prefill_step,
    make_serve_step,
)
from repro_torch.models import encdec as tencdec  # noqa: E402
from repro_torch.models import layers as tnn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.transformer import _attn_cfg  # noqa: E402
from repro_torch.quant import quantize_params  # noqa: E402
from repro_torch.utils.tree import tree_map, value_and_grad  # noqa: E402

NAME = "seamless-m4t-large-v2"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, S = 2, 12


def _configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(JAX_REGISTRY[NAME].reduced(), **kw),
            dataclasses.replace(REGISTRY[NAME].reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _reference_tree(dtype="float32"):
    """The reference's seed-0 weights as numpy, drawn once for the module;
    the tests copy before they change a tree."""
    return reference_params(_configs(dtype)[0], 0)


def _models(dtype="float32"):
    jcfg, tcfg = _configs(dtype)
    tree = _reference_tree(dtype)
    jparams = jax.tree.map(jnp.asarray, tree)
    if dtype == "bfloat16":  # numpy holds the reference's bf16 leaves as bf16
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    return jcfg, jparams, tcfg, convert.audio_params_from_numpy(tree, tcfg, device="cpu")


def _frames(n, cfg, seed=0):
    """(n, frontend_len, d_model) float32 frame embeddings from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.frontend_len, cfg.d_model)).astype(np.float32)


def _batches(tcfg, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S))
    labels = rng.integers(-1, tcfg.vocab_size, (B, S))
    frames = _frames(B, tcfg, seed)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
          "frames": jnp.asarray(frames)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
          "frames": torch.from_numpy(frames)}
    return jb, tb


def _np(t):
    return np.asarray(t.detach().float().numpy() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _assert_tree_close(got, want, tol, what=""):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
    else:
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol, err_msg=what)


@pytest.fixture(autouse=True)
def _cpu_launches_nothing():
    flash_attention.launches = flash_attention_bwd.launches = decode_attention.launches = 0
    yield
    assert flash_attention.launches == flash_attention_bwd.launches == 0
    assert decode_attention.launches == 0  # CPU: the plain versions only


# ------------------------------------------------------------------- layers
@pytest.mark.parametrize("qk_norm", [False, True])
def test_cross_attn_apply_matches_reference(qk_norm):
    """Queries from x (S 12), keys and values from a memory of 16 rows, with
    and without qk-norm: the output, and the gradient of sum(y^2) in every
    weight, in x and in the memory (the plain K4b's dK and dV flow into the
    memory), against `jax.value_and_grad` of the reference's layer."""
    jcfg, tcfg = _configs()
    jacfg = jencdec._attn_cfg(dataclasses.replace(jcfg, qk_norm=qk_norm), causal=False)
    tacfg = _attn_cfg(dataclasses.replace(tcfg, qk_norm=qk_norm), causal=False)
    assert tacfg._asdict() == jacfg._asdict()
    p = jnn.attn_init(jax.random.key(3), jacfg, jnp.float32)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, tcfg.frontend_len, tcfg.d_model)).astype(np.float32)

    def jloss(pp, xx, mm):
        y = jnn.cross_attn_apply(pp, jacfg, xx, mm)
        return jnp.sum(y**2), y

    (_, jy), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        p, jnp.asarray(x), jnp.asarray(mem))
    tp = tree_map(lambda a: torch.tensor(np.asarray(a)).requires_grad_(), np_tree(p))
    xt, mt = (torch.from_numpy(a).requires_grad_() for a in (x, mem))
    ty = tnn.cross_attn_apply(tp, tacfg, xt, mt)
    ty.pow(2).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), **F32_TOL)
    _assert_tree_close(tree_map(lambda t: t.grad, tp), np_tree(jgrads[0]), F32_TOL, "dparams")
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrads[1]), **F32_TOL)
    np.testing.assert_allclose(mt.grad.numpy(), np.asarray(jgrads[2]), **F32_TOL)
    assert float(jnp.abs(jgrads[2]).max()) > 1e-3  # the memory's gradient is carried


# -------------------------------------------------------------------- model
def test_encode_forward_loss_and_grad_match_reference():
    """The encoder's memory, the teacher-forced logits, the loss and its
    gradient in every weight (through the plain K4b in the encoder, the
    decoder's self-attention and its cross-attention) against the
    reference's, and the encoder non-causal: a later frame moves the first
    frame's memory row."""
    jcfg, jparams, tcfg, tparams = _models()
    jb, tb = _batches(tcfg)

    @jax.jit  # the memory, the forward and the loss's gradient in one program
    def jall(p):
        return (jencdec.encode(p, jcfg, jb["frames"], remat=False), JM.forward(p, jcfg, jb)[0],
                jax.value_and_grad(lambda q: JM.loss_fn(q, jcfg, jb))(p))

    jmem, jlogits, (jloss, jgrads) = jall(jparams)
    tmem = tencdec.encode(tparams, tcfg, tb["frames"])
    np.testing.assert_allclose(tmem.numpy(), np.asarray(jmem), **F32_TOL)
    tlogits, aux = TM.forward(tparams, tcfg, tb)
    assert tlogits.shape == (B, S, tcfg.vocab_size) and aux.item() == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    tloss, tgrads = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32_TOL)
    _assert_tree_close(tgrads, np_tree(jgrads), F32_TOL, "grad")
    assert tgrads["enc_layers"]["attn"]["wq"]["w"].abs().max().item() > 1e-4

    moved = tb["frames"].clone()
    moved[:, -1] += 1.0
    assert (tencdec.encode(tparams, tcfg, moved)[:, 0] - tmem[:, 0]).abs().max().item() > 1e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_init_and_decode_match_reference(dtype):
    """`init_decode_cache` with the frames: the cross K/V against the
    reference's (float32 cache; in a bf16 model every cross value is a bf16
    number, the projection rounded in the compute dtype before the cast to
    the cache's), and 8 teacher-forced decode steps' logits and caches."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jb, tb = _batches(tcfg)
    jcache = JM.init_decode_cache(jcfg, B, 16, dtype=jnp.float32, params=jparams,
                                  batch={"frames": jb["frames"]})
    tcache = TM.init_decode_cache(tcfg, B, 16, dtype=torch.float32, device="cpu",
                                  params=tparams, batch={"frames": tb["frames"]})
    assert set(tcache) == set(jcache) == {"k", "v", "cross_k", "cross_v"}
    assert tcache["cross_k"].shape == (tcfg.num_layers, B, tcfg.frontend_len,
                                       tcfg.num_kv_heads, tcfg.head_dim)
    _assert_tree_close(tcache, jax.tree.map(np.asarray, jcache), tol, "cache")
    if dtype == "bfloat16":
        for k in ("cross_k", "cross_v"):
            assert torch.equal(tcache[k].to(torch.bfloat16).float(), tcache[k])
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    for t in range(8):
        jl, jcache = jstep(jparams, jb["tokens"][:, t], jcache, t)
        tl, tcache = TM.decode_step(tparams, tcfg, tb["tokens"][:, t], tcache, t)
        np.testing.assert_allclose(_np(tl), _np(jl), **tol, err_msg=f"step {t}")
    _assert_tree_close(tcache, jax.tree.map(np.asarray, jcache), tol, "cache after 8 steps")


def test_decode_equals_the_teacher_forced_forward():
    """The port with itself: decode step t's logits equal the forward's at
    position t (the cross cache read with every frame valid)."""
    _, _, tcfg, tparams = _models()
    _, tb = _batches(tcfg)
    logits, _ = TM.forward(tparams, tcfg, tb)
    cache = TM.init_decode_cache(tcfg, B, 16, dtype=torch.float32, device="cpu", params=tparams,
                                 batch={"frames": tb["frames"]})
    for t in range(S):
        lt, cache = TM.decode_step(tparams, tcfg, tb["tokens"][:, t], cache, t)
        np.testing.assert_allclose(lt.numpy(), logits[:, t].numpy(), **F32_TOL)


def test_audio_needs_its_frames():
    """The cache and the server refuse to run without the frames, or with
    frames whose batch does not match."""
    _, _, tcfg, tparams = _models()
    frames = torch.from_numpy(_frames(2, tcfg))
    with pytest.raises(ValueError, match="runs the encoder"):
        TM.init_decode_cache(tcfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="are not"):
        TM.init_decode_cache(tcfg, 3, 16, device="cpu", params=tparams,
                             batch={"frames": frames})
    server = BatchServer(tcfg, tparams, ServeConfig(max_batch=2, cache_len=32), device="cpu")
    with pytest.raises(ValueError, match="needs the encoder's frames"):
        server.generate([[1, 2]], max_new_tokens=2)
    with pytest.raises(ValueError, match="do not match"):
        server.generate([[1, 2], [3], [4]], max_new_tokens=2, frames=frames)


def test_fed_lm_refuses_the_audio_family():
    """The federated LM's clients hold tokens only: an audio config is
    refused before anything is drawn."""
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    with pytest.raises(NotImplementedError, match="also needs frames"):
        make_fed_lm_problem(_configs()[1], num_clients=2, per_client_batch=1, seq_len=8,
                            device="cpu")


# ------------------------------------------------------------------ serving
def test_batch_server_matches_reference():
    """Greedy `BatchServer.generate` over frames in float32 (3 ragged prompts,
    one group): the reference's tokens; in bfloat16 the prefill and serve
    steps' logits at BF16_TOL."""
    jcfg, jparams, tcfg, tparams = _models()
    prompts = [[5, 7, 9, 11], [3, 4], [8, 2, 6]]
    frames = _frames(3, tcfg, seed=4)
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=4, cache_len=32)).generate(
        prompts, max_new_tokens=6, frames=jnp.asarray(frames))
    server = BatchServer(tcfg, tparams, ServeConfig(max_batch=4, cache_len=32), device="cpu")
    assert server.generate(prompts, max_new_tokens=6, frames=torch.from_numpy(frames)) == want

    jcfg, jparams, tcfg, tparams = _models("bfloat16")
    jb, tb = _batches(tcfg)
    got = make_prefill_step(tcfg, device="cpu")(tparams, tb)
    assert got.shape == (B, tcfg.vocab_size)
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    np.testing.assert_allclose(_np(got), _np(JM.forward(jparams, jcfg, jb)[0][:, -1]), **BF16_TOL)
    cache = TM.init_decode_cache(tcfg, B, 16, dtype=torch.float32, device="cpu", params=tparams,
                                 batch={"frames": tb["frames"]})
    jcache = JM.init_decode_cache(jcfg, B, 16, dtype=jnp.float32, params=jparams,
                                  batch={"frames": jb["frames"]})
    got, _ = make_serve_step(tcfg, device="cpu")(tparams, cache, tb["tokens"][:, 0], 0)
    want, _ = JM.decode_step(jparams, jcfg, jb["tokens"][:, 0], jcache, 0)
    np.testing.assert_allclose(_np(got), _np(want), **BF16_TOL)


def test_int8_tree_and_serving_match_reference():
    """`quantize_params` equal to the reference's eager one bit for bit (the
    embedding rows, the head and both layer stacks, a scale a column of each
    layer), and the int8 server's greedy tokens the reference's."""
    jcfg, jparams, tcfg, tparams = _models()
    jq = jax.tree.map(np.asarray, ref_quantize_params(jparams))
    tq = quantize_params(tparams)
    assert tq["enc_layers"]["mlp"]["up"]["w"]["s"].shape == (tcfg.encoder_layers, 1, tcfg.d_ff)
    assert set(tq["dec_layers"]["cross_attn"]["wk"]["w"]) == {"q", "s"}
    assert set(tq["embed"]["emb"]) == {"q", "s"}

    def same(got, want, path=""):
        if isinstance(want, dict):
            assert set(got) == set(want), path
            for k in want:
                same(got[k], want[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(got.float().numpy() if got.dtype != torch.int8
                                          else got.numpy(), np.asarray(want, np.float32)
                                          if want.dtype != np.int8 else want, err_msg=path)

    same(tq, jq)
    prompts = [[5, 7, 9], [3, 4, 1]]
    frames = _frames(2, tcfg, seed=5)
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=32, quantize=True)
                     ).generate(prompts, max_new_tokens=5, frames=jnp.asarray(frames))
    server = BatchServer(tcfg, tparams, ServeConfig(max_batch=2, cache_len=32, quantize=True),
                         device="cpu")
    assert server.generate(prompts, max_new_tokens=5, frames=torch.from_numpy(frames)) == want


# ----------------------------------------------------------------- training
def test_train_step_one_cohort_matches_reference():
    """The DeepSVRP train step (one cohort of 2 x 16 tokens over 2 x 16
    frames, 2 rounds with the reference's coins: a refresh and a plain
    round) against the reference's on a 1 x 1 debug mesh: x, w, gbar and
    the loss."""
    jcfg, tcfg = _configs()
    deep_step_matches_reference(jcfg, tcfg, _reference_tree(), frames=_frames(2, tcfg, seed=6))


def test_adamw_train_step_and_checkpoint(tmp_path):
    """One AdamW step (lr 3e-4, clip 1.0 active) over frames: the loss, the
    gradient norm and every parameter against the reference's step body;
    then the state saved and restored bit for bit."""
    jcfg, jparams, tcfg, _ = _models()
    lr, clip = 3e-4, 1.0
    batch = JBatcher(JDataset(vocab_size=tcfg.vocab_size, num_clients=1, alpha=0.5, seed=0),
                     num_cohorts=1, per_cohort_batch=2, seq_len=16).next_batch()
    batch["frames"] = _frames(2, tcfg, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(params):  # the body of repro.launch.steps.make_adamw_train_step
        loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, jb))(params)
        exact = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float64) ** 2) for g in jax.tree.leaves(grads)))
        grads, _ = jopt.clip_by_global_norm(grads, clip)
        return loss, exact, jopt.adamw_update(grads, jopt.adamw_init(params), params, lr=lr)[0]

    loss, exact, want = jstep(jparams)
    state = convert.adamw_state_from_numpy(
        jax.tree.map(np.asarray, {"params": jparams, "opt": jopt.adamw_init(jparams)}), tcfg,
        device="cpu")
    step, _ = make_adamw_train_step(tcfg, lr=lr, clip=clip, device="cpu")
    state, metrics = step(state, batch)
    assert float(exact) > clip
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(exact), rtol=1e-5)
    flat_got = _leaves(state.params)
    flat_want = _leaves(np_tree(want))
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, got), (_, ref) in zip(flat_got, flat_want):
        rel = np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref)
        assert rel <= 1e-5, (path, rel)

    save_checkpoint(str(tmp_path), 1, state)
    like = type(state)(tree_map(torch.zeros_like, state.params),
                       state.opt._replace(mu=tree_map(torch.zeros_like, state.opt.mu),
                                          nu=tree_map(torch.zeros_like, state.opt.nu), step=0))
    back = restore_checkpoint(str(tmp_path), 1, like, device="cpu")
    for (_, a), (_, b) in zip(_leaves(back._asdict()), _leaves(state._asdict())):
        assert torch.equal(a, b)
    assert back.opt.step == state.opt.step == 1


def _leaves(tree, path=()):
    """(key path, leaf) pairs, keys sorted at every level."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], path + (k,))]
    if isinstance(tree, tuple):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (i,))]
    if isinstance(tree, torch.Tensor):
        return [(path, tree.detach())]
    if isinstance(tree, np.ndarray):
        return [(path, tree)]
    return []
