"""The port's checkpoints (`repro_torch.checkpoint`) against `repro.checkpoint`,
on the CPU.

Both packages write the same npz layout, so a file written by either
restores in the other, bit for bit: bfloat16 and float32 leaves, the
DeepSVRP state (`SVRPServerState`) and the AdamW state (`AdamWTrainState`),
as NamedTuples and as the dicts the launchers save (``state._asdict()``).
The reference's ``rng`` (threefry key words) does not cross into a torch
generator: restored in the port, the state keeps ``like``'s generator; the
port's generator does not cross into the reference, whose files are read
back without it.  Resuming is exact: the port's native-coin rounds from a
restored state equal the rounds of an uninterrupted run, bit for bit.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_replay import np_tree, qwen2_configs  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.launch.steps import AdamWTrainState as JAdamWState  # noqa: E402
from repro.launch.steps import SVRPServerState as JSVRPState  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import OptState as JOptState  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.deep import DeepSVRPConfig  # noqa: E402
from repro_torch.data import ShardedBatcher, SyntheticLMDataset  # noqa: E402
from repro_torch.launch import AdamWTrainState, SVRPServerState, make_svrp_train_step  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import OptState  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x) -> np.ndarray:
    """A leaf's raw bits (bfloat16 as uint16), from either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16
                else x.numpy())
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same(got, want, what=""):
    """``got`` (a port tree) equal to ``want`` (a jax or port tree) bit for
    bit, leaf by leaf and key by key, dtypes included."""
    if isinstance(got, dict) or hasattr(got, "_fields"):
        g = got if isinstance(got, dict) else got._asdict()
        w = want if isinstance(want, dict) else want._asdict()
        assert set(g) == set(w), what
        for k in g:
            _assert_same(g[k], w[k], f"{what}/{k}")
    elif isinstance(got, int):
        assert got == int(want), what
    else:
        gb, wb = _bits(got), _bits(want)
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, (what, gb.dtype, wb.dtype)
        np.testing.assert_array_equal(gb, wb, err_msg=what)


def _ref_states(seed=0):
    """The reference's DeepSVRP and AdamW states of the reduced qwen2 in
    bf16, every leaf random (bf16 x and w, float32 gbar and moments)."""
    jcfg, tcfg = qwen2_configs("bfloat16")
    keys = jax.random.split(jax.random.key(seed), 4)
    x = JM.init_params(jcfg, keys[0])
    w = JM.init_params(jcfg, keys[1])
    f32 = lambda k: jax.tree.map(  # noqa: E731
        lambda p: jax.random.normal(k, p.shape, jnp.float32), x)
    svrp = JSVRPState(params=x, anchor=w, anchor_grad=f32(keys[2]),
                      step=jnp.asarray(5, jnp.int32), rng=jax.random.key_data(jax.random.key(3)))
    adamw = JAdamWState(params=x, opt=JOptState(step=jnp.asarray(3, jnp.int32), mu=f32(keys[2]),
                                                nu=jax.tree.map(jnp.abs, f32(keys[3]))))
    return tcfg, svrp, adamw


def _port_like(tcfg):
    """Port states of the reduced qwen2's shapes and dtypes, zeros."""
    zeros = tree_map(torch.zeros_like, TM.init_params(tcfg, torch.Generator(), device="cpu"))
    f32 = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32), zeros)
    svrp = SVRPServerState(params=zeros, anchor=tree_map(torch.clone, zeros), anchor_grad=f32,
                           step=0, rng=torch.Generator().manual_seed(11))
    adamw = AdamWTrainState(zeros, OptState(0, f32, tree_map(torch.clone, f32)))
    return svrp, adamw


@pytest.mark.parametrize("as_dict", [False, True])
def test_reference_files_restore_in_port(tmp_path, as_dict):
    """`repro.save_checkpoint` files of both states restore bit for bit; the
    reference's key leaves the port's generator as it is."""
    tcfg, jsvrp, jadamw = _ref_states()
    like_svrp, like_adamw = _port_like(tcfg)
    d = str(tmp_path)
    jckpt.save_checkpoint(d, 5, jsvrp._asdict() if as_dict else jsvrp)
    jckpt.save_checkpoint(d, 3, jadamw._asdict() if as_dict else jadamw)
    got = ckpt.restore_checkpoint(d, 5, like_svrp._asdict() if as_dict else like_svrp)
    if not as_dict:
        assert isinstance(got, SVRPServerState)
        got = got._asdict()
    assert got["rng"] is like_svrp.rng
    ref = jsvrp._asdict()
    for k in ("params", "anchor", "anchor_grad", "step"):
        _assert_same(got[k], ref[k], k)
    assert got["step"] == 5 and isinstance(got["step"], int)
    got = ckpt.restore_checkpoint(d, 3, like_adamw._asdict() if as_dict else like_adamw)
    if not as_dict:
        assert isinstance(got, AdamWTrainState) and isinstance(got.opt, OptState)
    _assert_same(got, jadamw._asdict() if as_dict else jadamw)


def test_port_files_restore_in_reference(tmp_path):
    """Port-written files of a params tree (bf16 and float32 leaves), the
    DeepSVRP state without its generator and the AdamW state restore bit for
    bit through `repro.restore_checkpoint`."""
    tcfg, jsvrp, jadamw = _ref_states(seed=1)
    svrp = convert.svrp_state_from_numpy(np_tree(jsvrp._asdict()), tcfg, device="cpu")
    adamw = convert.adamw_state_from_numpy(np_tree(jadamw), tcfg, device="cpu")
    out = str(tmp_path)
    mixed = {"bf16": svrp.params, "f32": {"gbar": svrp.anchor_grad}, "seq": [svrp.params["ln_f"]]}
    ckpt.save_checkpoint(out, 7, mixed)
    ckpt.save_checkpoint(out, 8, {k: v for k, v in svrp._asdict().items() if k != "rng"})
    ckpt.save_checkpoint(out, 9, adamw)
    jmixed = {"bf16": jsvrp.params, "f32": {"gbar": jsvrp.anchor_grad},
              "seq": [jsvrp.params["ln_f"]]}
    zeros = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    back = jckpt.restore_checkpoint(out, 7, zeros(jmixed))
    _assert_same(mixed["bf16"], back["bf16"])
    _assert_same(mixed["f32"], back["f32"])
    _assert_same(mixed["seq"][0], back["seq"][0])
    jlike = {k: v for k, v in jsvrp._asdict().items() if k != "rng"}
    back = jckpt.restore_checkpoint(out, 8, zeros(jlike))
    _assert_same({k: v for k, v in svrp._asdict().items() if k != "rng"}, back)
    back = jckpt.restore_checkpoint(out, 9, zeros(jadamw))
    assert isinstance(back, JAdamWState) and int(back.opt.step) == 3
    _assert_same(adamw, back)


def test_latest_step_and_atomic_write(tmp_path, monkeypatch):
    d = str(tmp_path / "ckpt")
    assert ckpt.latest_step(d) is None
    tree = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3, dtype=torch.bfloat16),
            "step": 7, "nested": [torch.zeros(2), torch.ones(2)]}
    for s in (7, 12, 3):
        ckpt.save_checkpoint(d, s, tree)
    assert ckpt.latest_step(d) == 12
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.npz" for s in (3, 7, 12)]
    like = tree_map(lambda t: t, tree)
    _assert_same(ckpt.restore_checkpoint(d, 12, like), tree)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.checkpoint.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_checkpoint(d, 13, tree)
    assert sorted(os.listdir(d)) == [f"ckpt_{s:08d}.npz" for s in (3, 7, 12)]  # no .tmp left
    with pytest.raises(TypeError, match="leaf x is str"):
        ckpt.save_checkpoint(d, 14, {"x": "not a leaf"})


def _rounds(step, state, batches):
    for batch in batches:
        state, _ = step(state, batch)
    return state


def test_resume_is_exact(tmp_path):
    """4 native-coin rounds (p 0.5) equal 2 rounds, a save, a restore into
    a fresh state and 2 more rounds, bit for bit: the restored generator
    draws the coins the uninterrupted run drew."""
    _, tcfg = qwen2_configs()
    svrp = DeepSVRPConfig(eta=0.5, local_lr=0.2, local_steps=1, anchor_prob=0.5)
    step, helpers = make_svrp_train_step(tcfg, svrp, cohorts=2, device="cpu")
    toks = np.random.default_rng(4).integers(0, tcfg.vocab_size, (4, 4, 12))
    batches = [{"tokens": t, "labels": t} for t in toks]
    straight = _rounds(step, helpers["init_state"](torch.Generator().manual_seed(0)), batches)
    half = _rounds(step, helpers["init_state"](torch.Generator().manual_seed(0)), batches[:2])
    ckpt.save_checkpoint(str(tmp_path), 2, half._asdict())
    fresh = helpers["init_state"](torch.Generator().manual_seed(5))
    resumed = ckpt.restore_checkpoint(str(tmp_path), 2, fresh)
    assert resumed.step == 2 and resumed.rng is not fresh.rng
    resumed = _rounds(step, resumed, batches[2:])
    assert resumed.step == straight.step == 4
    for field in ("params", "anchor", "anchor_grad"):
        for a, b in zip(tree_leaves(getattr(resumed, field)), tree_leaves(getattr(straight, field))):
            assert torch.equal(a, b), field
    assert torch.equal(resumed.rng.get_state(), straight.rng.get_state())


def test_train_launcher_checkpoints(tmp_path):
    """``--ckpt-every 2`` over 3 rounds writes round 2's state only, and it
    restores to the state of 2 rounds of the train step on the launcher's
    data and seed-0 weights."""
    d = str(tmp_path / "run")
    argv = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--cohorts", "2",
            "--per-cohort-batch", "1", "--seq-len", "8", "--local-steps", "1"]
    train_main(argv + ["--rounds", "3", "--ckpt-dir", d, "--ckpt-every", "2"])
    assert os.listdir(d) == ["ckpt_00000002.npz"] and ckpt.latest_step(d) == 2

    _, tcfg = qwen2_configs()
    svrp = DeepSVRPConfig(eta=1.0, local_lr=0.1, local_steps=1, anchor_prob=0.0625)
    step, helpers = make_svrp_train_step(tcfg, svrp, cohorts=2, device="cpu")
    ds = SyntheticLMDataset(vocab_size=tcfg.vocab_size, num_clients=2, alpha=0.5, seed=0)
    batcher = ShardedBatcher(ds, num_cohorts=2, per_cohort_batch=1, seq_len=8)
    want = _rounds(step, helpers["init_state"](), [batcher.next_batch() for _ in range(2)])
    got = ckpt.restore_checkpoint(d, 2, helpers["init_state"]())
    assert got.step == 2
    for field in ("params", "anchor", "anchor_grad"):
        _assert_same(getattr(got, field), getattr(want, field), field)
    assert torch.equal(got.rng.get_state(), want.rng.get_state())
