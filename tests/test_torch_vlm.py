"""The port's vlm family (`repro_torch.models.vlm`) against `repro`, on the CPU.

The reduced internvl2-76b (2 layers, d 256, 4/4 heads of Dh 64, vocab 512)
in float32, and in bfloat16 where a test says so, over P = 8 patches of the
vision width 3200 and 12 text tokens.  The reference's seed-0 weights
(drawn once for the module: its jitted init and the other XLA compiles are
most of this file's time) cross as numpy (`convert.vlm_params_from_numpy`);
tokens and patch embeddings come from numpy seeds.  On the CPU the port's
attention is the plain version of K4, K4b and K5.

Tolerances: F32_TOL of tests/test_torch_models.py (rtol = atol = 1e-4,
summation order only) on logits, losses, gradients and decode steps;
PROJ_TOL (1e-5) on the projector alone, which the erf form of the GELU
misses; BF16_TOL (5e-2) in bfloat16; greedy tokens equal in float32; int8
trees bit for bit; the training steps tests/test_torch_train.py's
(`deep_step_matches_reference`) and tests/test_torch_encdec.py's; the
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
from repro import checkpoint as jckpt  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro.configs import REGISTRY as JAX_REGISTRY  # noqa: E402
from repro.data import ShardedBatcher as JBatcher  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.serve import BatchServer as JaxServer  # noqa: E402
from repro.launch.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.launch.steps import AdamWTrainState as JAdamWState  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import vlm as jvlm  # noqa: E402
from repro.quant import quantize_params as ref_quantize_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.configs import REGISTRY  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd  # noqa: E402
from repro_torch.launch import (  # noqa: E402
    BatchServer,
    ServeConfig,
    make_adamw_train_step,
    make_prefill_step,
)
from repro_torch.models import layers as tnn  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import transformer as ttransformer  # noqa: E402
from repro_torch.models import vlm as tvlm  # noqa: E402
from repro_torch.quant import quantize_named, quantize_params  # noqa: E402
from repro_torch.utils.tree import value_and_grad  # noqa: E402

NAME = "internvl2-76b"
F32_TOL = dict(rtol=1e-4, atol=1e-4)
PROJ_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
B, P, S = 2, 8, 12


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
    return jcfg, jparams, tcfg, convert.vlm_params_from_numpy(tree, tcfg, device="cpu")


def _patches(n, p=P, seed=0):
    """(n, p, 3200) float32 patch embeddings from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, p, tvlm.DEFAULT_VISION_DIM)).astype(np.float32)


def _batches(tcfg, seed=1, p=P):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, tcfg.vocab_size, (B, S))
    labels = rng.integers(-1, tcfg.vocab_size, (B, S))
    patches = _patches(B, p, seed)
    jb = {"tokens": jnp.asarray(tokens, jnp.int32), "labels": jnp.asarray(labels, jnp.int32),
          "patches": jnp.asarray(patches)}
    tb = {"tokens": torch.from_numpy(tokens), "labels": torch.from_numpy(labels),
          "patches": torch.from_numpy(patches)}
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


# ----------------------------------------------------------------- the model
def test_dense_init_draws_layers_in_place():
    """`transformer.stacked_init` (every leaf allocated once, layers drawn
    into it) gives the values `torch.stack` over separately drawn layers
    gives, from the same generator: the dense family's draws are unchanged."""
    cfg = REGISTRY["llama3.2-3b"].reduced()
    got = TM.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(3)
    dtype = getattr(torch, cfg.param_dtype)
    torch.randn((cfg.vocab_size, cfg.d_model), generator=gen)  # the embedding's draw
    drawn = [ttransformer._layer_init(gen, cfg, dtype, "cpu") for _ in range(cfg.num_layers)]
    want = jax.tree.map(lambda *leaves: torch.stack(leaves), *drawn)
    for a, b in zip(jax.tree.leaves(got["layers"]), jax.tree.leaves(want)):
        assert torch.equal(a, b)


def test_project_patches_matches_reference():
    """The projector (RMSNorm over 3200, fc1, GELU, fc2) against the
    reference's at PROJ_TOL; the GELU is the tanh form (`jax.nn.gelu`'s
    default): the erf form misses that limit."""
    jcfg, jparams, tcfg, tparams = _models()
    x = _patches(B, seed=2) * 3.0  # GELU's two forms part most near |x| ~ 2
    want = np.asarray(jax.jit(lambda p, a: jvlm.project_patches(p, jcfg, a))(
        jparams, jnp.asarray(x)))
    got = tvlm.project_patches(tparams, tcfg, torch.from_numpy(x))
    assert got.shape == (B, P, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, **PROJ_TOL)
    proj = tparams["projector"]
    h = tnn.linear_apply(proj["fc1"], tnn.rmsnorm_apply(proj["ln"], torch.from_numpy(x),
                                                        tcfg.norm_eps))
    erf = tnn.linear_apply(proj["fc2"], torch.nn.functional.gelu(h)).numpy()
    assert not np.allclose(erf, want, **PROJ_TOL)


def test_forward_loss_and_grad_match_reference():
    """The logits over patches + text, the loss (patch positions masked) and
    its gradient in every weight, the projector's included, against the
    reference's; the loss is the cross entropy of the text positions alone,
    and a patch moves the text's logits (causal over the whole sequence)."""
    jcfg, jparams, tcfg, tparams = _models()
    jb, tb = _batches(tcfg)

    @jax.jit
    def jall(p):
        return JM.forward(p, jcfg, jb)[0], jax.value_and_grad(lambda q: JM.loss_fn(q, jcfg, jb))(p)

    jlogits, (jloss, jgrads) = jall(jparams)
    tlogits, aux = TM.forward(tparams, tcfg, tb)
    assert tlogits.shape == (B, P + S, tcfg.vocab_size) and aux.item() == 0.0
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **F32_TOL)
    tloss, tgrads = value_and_grad(lambda p, b: TM.loss_fn(p, tcfg, b), tparams, tb)
    np.testing.assert_allclose(tloss.item(), float(jloss), **F32_TOL)
    _assert_tree_close(tgrads, np_tree(jgrads), F32_TOL, "grad")
    for name in ("fc1", "fc2"):
        assert tgrads["projector"][name]["w"].abs().max().item() > 1e-5
    text = tnn.cross_entropy_loss(tlogits[:, P:], tb["labels"])
    np.testing.assert_allclose(tloss.item(), text.item(), rtol=1e-6)

    moved = dict(tb, patches=tb["patches"].clone())
    moved["patches"][:, -1] += 1.0
    assert (TM.forward(tparams, tcfg, moved)[0][:, P:] - tlogits[:, P:]).abs().max() > 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_step_matches_reference(dtype):
    """`make_prefill_step` over patches + text: the last position's logits
    (a text position), not a view of the whole logits, against the
    reference's forward."""
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jcfg, jparams, tcfg, tparams = _models(dtype)
    jb, tb = _batches(tcfg)
    got = make_prefill_step(tcfg, device="cpu")(tparams, tb)
    assert got.shape == (B, tcfg.vocab_size)
    assert got.untyped_storage().nbytes() == got.numel() * got.element_size()
    np.testing.assert_allclose(_np(got), _np(JM.forward(jparams, jcfg, jb)[0][:, -1]), **tol)


def test_decode_equals_the_forward_without_patches():
    """Decode is the dense family's: with an empty patch prefix the forward's
    logits at position t equal decode step t's (tests/test_arch_smoke.py's
    check), and each step equals the reference's decode step."""
    jcfg, jparams, tcfg, tparams = _models()
    jb, tb = _batches(tcfg, p=0)
    logits, _ = TM.forward(tparams, tcfg, tb)
    cache = TM.init_decode_cache(tcfg, B, 16, dtype=torch.float32, device="cpu")
    jcache = JM.init_decode_cache(jcfg, B, 16, dtype=jnp.float32)
    jstep = jax.jit(lambda p, tok, c, pos: JM.decode_step(p, jcfg, tok, c, pos))
    for t in range(S):
        lt, cache = TM.decode_step(tparams, tcfg, tb["tokens"][:, t], cache, t)
        jl, jcache = jstep(jparams, jb["tokens"][:, t], jcache, t)
        np.testing.assert_allclose(lt.numpy(), logits[:, t].numpy(), **F32_TOL)
        np.testing.assert_allclose(lt.numpy(), np.asarray(jl), **F32_TOL, err_msg=f"step {t}")


def test_fed_lm_refuses_the_vlm_family():
    """The federated LM's clients hold tokens only: a vlm config is refused
    before anything is drawn."""
    from repro_torch.problems.fed_lm import make_fed_lm_problem

    with pytest.raises(NotImplementedError, match="also needs patches"):
        make_fed_lm_problem(_configs()[1], num_clients=2, per_client_batch=1, seq_len=8,
                            device="cpu")


# ------------------------------------------------------------------ serving
def test_batch_server_matches_reference():
    """Greedy `BatchServer.generate` on text prompts (the reference's server
    takes no patches) in float32, 3 ragged prompts in one group: the
    reference's tokens."""
    jcfg, jparams, tcfg, tparams = _models()
    prompts = [[5, 7, 9, 11], [3, 4], [8, 2, 6]]
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=4, cache_len=32)).generate(
        prompts, max_new_tokens=6)
    server = BatchServer(tcfg, tparams, ServeConfig(max_batch=4, cache_len=32), device="cpu")
    assert server.generate(prompts, max_new_tokens=6) == want


def test_int8_tree_and_serving_match_reference():
    """`quantize_params` equal to the reference's eager one bit for bit (the
    embedding rows, the head, the layer stack and the projector's fc1 and
    fc2; its norm stays as it is), also leaf by leaf by its rule
    `quantize_named` (how a tree too large to copy is quantized in place),
    and the int8 server's greedy tokens the reference's."""
    jcfg, jparams, tcfg, tparams = _models()
    jq = jax.tree.map(np.asarray, ref_quantize_params(jparams))
    tq = quantize_params(tparams)
    assert set(tq["projector"]["fc1"]["w"]) == set(tq["projector"]["fc2"]["w"]) == {"q", "s"}
    assert tq["projector"]["fc1"]["w"]["s"].shape == (1, tcfg.d_model)
    assert isinstance(tq["projector"]["ln"]["scale"], torch.Tensor)

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
    leafwise = jax.tree_util.tree_map_with_path(
        lambda path, t: quantize_named(path[-1].key, t), jax.tree.map(torch.clone, tparams))
    same(leafwise, jq)
    prompts = [[5, 7, 9], [3, 4, 1]]
    want = JaxServer(jcfg, jparams, JaxServeConfig(max_batch=2, cache_len=32, quantize=True)
                     ).generate(prompts, max_new_tokens=5)
    server = BatchServer(tcfg, tparams, ServeConfig(max_batch=2, cache_len=32, quantize=True),
                         device="cpu")
    assert server.generate(prompts, max_new_tokens=5) == want


# ----------------------------------------------------------------- training
def test_train_step_one_cohort_matches_reference():
    """The DeepSVRP train step (one cohort of 2 x 16 tokens after 2 x 8
    patches, 2 rounds with the reference's coins: a refresh and a plain
    round) against the reference's on a 1 x 1 debug mesh: x, w, gbar and
    the loss."""
    jcfg, tcfg = _configs()
    deep_step_matches_reference(jcfg, tcfg, _reference_tree(), patches=_patches(2, seed=6))


def test_train_step_two_cohorts_matches_reference():
    """Two cohorts of 2 x 16 tokens after 2 x 8 patches each (patch rows
    split with their token rows) against the reference's step on a 2 x 1
    debug mesh, in a subprocess with two host devices: x, w, gbar and the
    loss after each of 2 rounds (a refresh and a plain round)."""
    jcfg, tcfg = _configs()
    deep_step_matches_reference(jcfg, tcfg, _reference_tree(), patches=_patches(4, seed=10),
                                cohorts=2)


def test_train_step_splits_patches_over_cohorts():
    """Two cohorts of 2 rows: each cohort's patch rows go with its token
    rows.  The round's loss (the cohort mean of the loss at w) equals the
    mean of `loss_fn` over each cohort's rows, and the rows' patches matter:
    with the cohorts' patches swapped the loss moves."""
    from repro_torch.core.deep import DeepSVRPConfig
    from repro_torch.launch import SVRPServerState, make_svrp_train_step

    _, _, tcfg, tparams = _models()
    rng = np.random.default_rng(8)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (4, S)))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1),
             "patches": torch.from_numpy(_patches(4, seed=9))}
    step, _ = make_svrp_train_step(tcfg, DeepSVRPConfig(local_steps=1), cohorts=2, device="cpu")

    def round_loss(b):
        gbar = jax.tree.map(torch.zeros_like, tparams)
        state = SVRPServerState(tparams, tparams, gbar, 0, torch.Generator().manual_seed(0))
        return step(state, b, refresh=False)[1]["loss"].item()

    want = np.mean([TM.loss_fn(tparams, tcfg, {k: v[r] for k, v in batch.items()}).item()
                    for r in (slice(0, 2), slice(2, 4))])
    np.testing.assert_allclose(round_loss(batch), want, rtol=1e-6)
    swapped = dict(batch, patches=batch["patches"][[2, 3, 0, 1]])
    assert abs(round_loss(swapped) - want) > 1e-4


def test_adamw_train_step_and_checkpoint(tmp_path):
    """One AdamW step (lr 3e-4, clip 1.0 active) over patches + text: the
    loss, the gradient norm and every parameter against the reference's step
    body; then the state saved by the port and restored by the reference,
    bit for bit."""
    jcfg, jparams, tcfg, _ = _models()
    lr, clip = 3e-4, 1.0
    batch = JBatcher(JDataset(vocab_size=tcfg.vocab_size, num_clients=1, alpha=0.5, seed=0),
                     num_cohorts=1, per_cohort_batch=2, seq_len=16).next_batch()
    batch["patches"] = _patches(2, seed=7)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    @jax.jit
    def jstep(params):  # the body of repro.launch.steps.make_adamw_train_step
        loss, grads = jax.value_and_grad(lambda p: JM.loss_fn(p, jcfg, jb))(params)
        exact = jnp.sqrt(sum(jnp.sum(g.astype(jnp.float64) ** 2) for g in jax.tree.leaves(grads)))
        grads, _ = jopt.clip_by_global_norm(grads, clip)
        return loss, exact, jopt.adamw_update(grads, jopt.adamw_init(params), params, lr=lr)[0]

    loss, exact, want = jstep(jparams)
    jstate = {"params": jparams, "opt": jopt.adamw_init(jparams)}
    state = convert.adamw_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    step, _ = make_adamw_train_step(tcfg, lr=lr, clip=clip, device="cpu")
    state, metrics = step(state, batch)
    assert float(exact) > clip
    np.testing.assert_allclose(metrics["loss"].item(), float(loss), rtol=1e-6)
    np.testing.assert_allclose(metrics["grad_norm"].item(), float(exact), rtol=1e-5)
    got, ref = jax.tree.leaves_with_path(state.params), jax.tree.leaves_with_path(np_tree(want))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        rel = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
        assert rel <= 1e-5, (path, rel)

    save_checkpoint(str(tmp_path), 1, state)
    like = jax.tree.map(jnp.zeros_like, JAdamWState(**jstate))
    back = jckpt.restore_checkpoint(str(tmp_path), 1, like)
    assert isinstance(back, JAdamWState) and int(back.opt.step) == 1
    for (path, a), (_, b) in zip(jax.tree.leaves_with_path(state), jax.tree.leaves_with_path(
            back)):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(path))
