"""Port parity for bfloat16 mixed-precision training of the recognizer and
the perceptual autoencoder: ``model.compute_dtype = "bfloat16"`` in the
port's ``HWRTrainer`` and ``AutoTrainer`` against the JAX trainers' bf16
steps from the same weights and batch (augmentation and dropout off), and
``train -r -a model.compute_dtype=bfloat16`` over a float32 run (the
port's own, and a JAX run directory).

bf16 rounds each conv's sum, and the two frameworks sum in other orders, so
neither package reproduces the other's bits.  Every tolerance is a
multiple (``RATIO``, at most 3) of the JAX package's own bf16-vs-float32
distance, measured in the same test from the same state: the JAX float32
step beside its bf16 one.
"""

import copy
import json
import pathlib
import shutil
import threading

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.config import load_config as j_load
from handwriting_line_generation_tpu.training.auto_trainer import (
    AutoState, AutoTrainer as JAutoTrainer,
)
from handwriting_line_generation_tpu.training.hwr_trainer import (
    HWRState, HWRTrainer as JHWRTrainer,
)
from handwriting_line_generation_tpu.utils.checkpoint import \
    CheckpointManager as JCheckpointManager
from handwriting_line_generation_tpu_torch import train as p_train
from handwriting_line_generation_tpu_torch.config import load_config
from handwriting_line_generation_tpu_torch.convert import (
    convert_autoencoder_params, convert_hwr_params,
)
from handwriting_line_generation_tpu_torch.init import (
    init_autoencoder_params, init_hwr_params,
)
from handwriting_line_generation_tpu_torch.training import (
    auto_trainer as p_auto, hwr_trainer as p_hwr,
)
from test_torch_auto_trainer import _no_dropout as _port_no_dropout
from test_torch_gan_trainer import F64_COMPILE, _adam_step_bound
from test_torch_jax_resume import (
    CONFIGS as CONFIGS_RUN, RUN, _configs, _jax_no_dropout,
)

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = REPO / "configs"
STEPS = 3
K = 2
# the largest multiple of JAX's own bf16-vs-float32 distance allowed for
# the port's bf16 against JAX's bf16 (the measured ratios are in each
# test's note)
RATIO = 3.0
NC = 12                       # the autoencoder steps' classes
JAX_TRAINERS = {"hwr": JHWRTrainer, "auto": JAutoTrainer}
STATES = {"hwr": HWRState, "auto": AutoState}
PORT_TRAINERS = {"hwr": p_hwr.HWRTrainer, "auto": p_auto.AutoTrainer}
PORT_MODULES = {"hwr": p_hwr, "auto": p_auto}
CONVERT = {"hwr": convert_hwr_params, "auto": convert_autoencoder_params}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread (several
    test processes share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


class _CtcSpy:
    """Records the dtype of every log-prob tensor a trainer module hands
    to CTC."""

    def __init__(self, mp, module):
        self.dtypes = []
        real = module.ctc_loss_fast

        def spy(logp, *a, **kw):
            self.dtypes.append(logp.dtype)
            return real(logp, *a, **kw)
        mp.setattr(module, "ctc_loss_fast", spy)


def _check_dtypes(trainer):
    """The models compute in bf16; every parameter, gradient and Adam
    moment is float32."""
    assert {m.dtype for m in trainer.model.modules()
            if isinstance(getattr(m, "dtype", None), torch.dtype)} == \
        {torch.bfloat16}
    for name, p in trainer.model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad is None or p.grad.dtype == torch.float32, name
    for st in trainer.optimizer.state_dict()["state"].values():
        for k in ("exp_avg", "exp_avg_sq"):
            assert st[k].dtype == torch.float32, k


def _within(err, own, what, ratios=None):
    """``err`` (port bf16 against JAX bf16) within ``RATIO`` times
    ``own`` (JAX bf16 against JAX float32)."""
    if ratios is not None:
        ratios[what] = err / own
    assert err <= RATIO * own, (what, err, own)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _rel_l2(got, want):
    a = np.concatenate([np.asarray(g, np.float64).ravel() for g in got])
    b = np.concatenate([np.asarray(w, np.float64).ravel() for w in want])
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _host(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _dev(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _batch(which, seed=0):
    """Two u8 lines (64 x 64 for the recognizer, 64 x 128 for the
    autoencoder), labels and ink widths."""
    W, C = (64, 80) if which == "hwr" else (128, NC)
    rng = np.random.default_rng(seed)
    image = rng.integers(0, 256, (2, 64, W, 1)).astype(np.uint8)
    label_lengths = np.array([6, 3], np.int32)
    label = np.zeros((2, 6), np.int32)
    for b in range(2):
        label[b, :label_lengths[b]] = rng.integers(1, C, label_lengths[b])
    width = np.array([W, 5 * W // 8], np.int32)
    return image, label, label_lengths, width


def _step_configs(which):
    """The config of the step tests (JAX's and the port's):
    ``iam_hwr`` without augmentation, ``iam_auto_2tight`` at ``NC``
    classes."""
    path = str(CONFIGS / ("iam_hwr.json" if which == "hwr"
                          else "iam_auto_2tight.json"))
    jcfg, pcfg = j_load(path), load_config(path)
    for c in (jcfg, pcfg):
        if which == "hwr":
            c.data.augmentation = None
        else:
            c.autoencoder.hwr_classes = NC
    return jcfg, pcfg


def _init_tree(which, cfg, num_class, seed=0):
    if which == "hwr":
        return init_hwr_params(cfg.model.hwr, num_class, seed=seed)
    return init_autoencoder_params("2tight", num_class, seed=seed)


def _state(which, jt, tree, seed=0):
    """A JAX train state from a numpy tree, as the trainer's
    ``init_state`` builds it (without compiling flax's init)."""
    params = _dev(tree)
    return STATES[which](step=jnp.zeros((), jnp.int32), params=params,
                         opt_state=jt.tx.init(params),
                         rng=jax.random.PRNGKey(seed + 1))


def _compiler(lowered, out, key):
    """Compile without LLVM's optimizations (half the compile time; the
    steps run at two-line shapes)."""
    def job():
        out[key] = lowered.compile(F64_COMPILE)
    return job


class _Jax:
    """The JAX package's train steps of each trainer in each dtype, from
    one tree, on one batch (the autoencoder's dropout off): traced here
    and compiled ahead, each in its own thread (XLA compiles outside the
    GIL).  ``steps``: ``STEPS`` steps of each; ``runs``: the float32
    trajectory's state after ``K`` steps written as a JAX run directory
    (``checkpoint-latest.msgpack`` by the JAX ``CheckpointManager``), and
    step ``K + 1`` from it in bf16 and in float32."""

    def __init__(self, tmp_path_factory):
        with pytest.MonkeyPatch.context() as mp:
            _jax_no_dropout(mp)
            lowered = {}
            for which in ("hwr", "auto"):
                jcfg, _ = _step_configs(which)
                num = J_CHARSET.num_class if which == "hwr" else NC
                tree = _init_tree(which, jcfg, num)
                batch = [jnp.asarray(a) for a in _batch(which)]
                for dtype in ("bfloat16", "float32"):
                    cfg = copy.deepcopy(jcfg)
                    cfg.model.compute_dtype = dtype
                    jt = JAX_TRAINERS[which](cfg)
                    state = _state(which, jt, tree)
                    s = dict(tree=tree, batch=batch, state=_host(state),
                             b1=cfg.optimizer.betas[0], name=cfg.name)
                    s["compile"] = _compiler(type(jt).train_step.lower(
                        jt, state, *batch), s, "fn")
                    lowered[(which, dtype)] = s
            threads = [threading.Thread(target=s["compile"])
                       for s in lowered.values()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            self.steps = {k: self._run_steps(s) for k, s in lowered.items()}
            self.runs = {w: self._run(w, lowered[(w, "bfloat16")],
                                      lowered[(w, "float32")],
                                      tmp_path_factory.mktemp(f"jax_{w}"))
                         for w in ("hwr", "auto")}

    @staticmethod
    def _run_steps(s):
        """Each step's loss and log-probs, the first step's gradient (read
        back from Adam's first moment: ``mu = (1 - b1) g``), the state
        after ``K`` steps and the parameters after the last."""
        state, outs = _dev(s["state"]), []
        for step in range(STEPS):
            state, out = s["fn"](state, *s["batch"])
            outs.append(_host(out))
            if step == 0:
                grads = jax.tree_util.tree_map(
                    lambda m: np.asarray(m) / (1 - s["b1"]),
                    state.opt_state[0].mu)
            if step == K - 1:
                at_k = _host(state)
        return dict(tree=s["tree"], outs=outs, grads=grads, at_k=at_k,
                    params=_host(state.params))

    def _run(self, which, s16, s32, root):
        """The float32 run's checkpoint at step ``K`` in ``root``, and step
        ``K + 1`` from it in each dtype: the parameters, Adam's first
        moments and the outputs after it."""
        before = self.steps[(which, "float32")]["at_k"]
        run_dir = root / s32["name"]
        JCheckpointManager(str(run_dir), save_step=0,
                           save_step_minor=K).maybe_save(
            K, before, {"name": s32["name"]})

        def step(s):
            after, out = s["fn"](_dev(before), *s["batch"])
            return dict(params=_host(after.params),
                        mu=_host(after.opt_state[0].mu), out=_host(out))
        return dict(root=root, name=s32["name"], before=before,
                    steps={"bfloat16": step(s16), "float32": step(s32)})


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return _Jax(tmp_path_factory)


# -- three bf16 steps -------------------------------------------------------


@pytest.mark.compile
@pytest.mark.parametrize("which", ["hwr", "auto"])
def test_bf16_steps_match_jax(jax_side, which, monkeypatch):
    """Three bf16 steps (``iam_hwr`` without augmentation;
    ``iam_auto_2tight`` with dropout off on both sides) from the same
    weights on one batch: each step's log-probs (max abs), the losses
    (the median over the steps of each one's distance: a single scalar's
    bf16-vs-float32 distance is no yardstick, it may fall near zero by
    chance), the first step's gradients (relative L2 over all tensors,
    and each tensor's max abs) and the parameters after (their mean
    difference), each within ``RATIO`` times JAX's own bf16-vs-float32
    distance of JAX's bf16 run; the parameters also within Adam's bound of it, as the
    float32 tests hold them.  The models compute in bf16, every parameter
    and Adam moment stays float32 and CTC reads float32 log-probs."""
    j16, j32 = (jax_side.steps[(which, d)] for d in ("bfloat16", "float32"))
    _, pcfg = _step_configs(which)
    pcfg.model.compute_dtype = "bfloat16"
    pt = PORT_TRAINERS[which](pcfg, device="cpu")
    pt.init_state(seed=0, params=j16["tree"])
    _port_no_dropout(pt)
    spy = _CtcSpy(monkeypatch, PORT_MODULES[which])
    batch = _batch(which)
    convert = CONVERT[which]
    ratios = {}
    losses = ("loss",) + (("autoLoss", "recogLoss") if which == "auto"
                          else ())
    dist = {k: [] for k in losses}
    for step in range(STEPS):
        got = pt.train_step(*batch)
        if which == "hwr":
            got = dict(zip(("loss", "logp"), got))
        assert got["logp"].dtype == torch.float32
        a, b = j16["outs"][step]["logp"], j32["outs"][step]["logp"]
        _within(_max_abs(got["logp"].numpy(), a), _max_abs(a, b),
                f"logp {step}", ratios)
        for k in losses:
            a, b = j16["outs"][step][k], j32["outs"][step][k]
            dist[k].append((_max_abs(got[k].numpy(), a), _max_abs(a, b)))
        if step == 0:
            g16, g32 = convert(j16["grads"]), convert(j32["grads"])
            names = [n for n, _ in pt.model.named_parameters()]
            grads = {n: p.grad.numpy() for n, p in
                     pt.model.named_parameters()}
            _within(_rel_l2([grads[n] for n in names],
                            [g16[n].numpy() for n in names]),
                    _rel_l2([g32[n].numpy() for n in names],
                            [g16[n].numpy() for n in names]),
                    "gradient L2", ratios)
            for n in names:
                _within(_max_abs(grads[n], g16[n]),
                        _max_abs(g32[n], g16[n]), f"gradient {n}", ratios)
    for k, d in dist.items():
        _within(np.median([e for e, _ in d]), np.median([o for _, o in d]),
                f"{k} (median over the steps)", ratios)
    _check_dtypes(pt)
    assert spy.dtypes == [torch.float32] * STEPS

    # Adam's t-th step is at most _adam_step_bound(b1, b2, t) lr (1.054 lr
    # at the second for betas (0.5, 0.999)); a near-zero gradient of
    # opposite sign costs up to two steps' worth
    bound = 2 * pcfg.optimizer.lr * sum(
        _adam_step_bound(*pcfg.optimizer.betas, t)
        for t in range(1, STEPS + 1)) + 1e-6
    p16, p32 = convert(j16["params"]), convert(j32["params"])
    diffs, owns = [], []
    for name, p in pt.model.named_parameters():
        d = np.abs(p.detach().numpy() - p16[name].numpy())
        assert d.max() <= bound, (name, d.max())
        diffs.append(d.ravel())
        owns.append(np.abs(p32[name].numpy() - p16[name].numpy()).ravel())
    _within(np.concatenate(diffs).mean(), np.concatenate(owns).mean(),
            "parameters' mean difference", ratios)
    print(f"{which} bf16 ratios, worst 5:", json.dumps(dict(sorted(
        ((k, round(float(v), 3)) for k, v in ratios.items()),
        key=lambda kv: -kv[1])[:5])))


# -- resuming a float32 run into bf16 ---------------------------------------


def _cli(which, save_dir, iterations, overrides, *extra):
    """``train -c <config> --device cpu -i N`` over the mini-IAM fixture
    (``tests/test_torch_jax_resume.py``'s run overrides) with
    ``overrides`` and ``extra``; returns the trainer the CLI built."""
    made = []
    cls = PORT_TRAINERS[which]
    real = cls.train

    def train(self, *a, **kw):
        made.append(self)
        return real(self, *a, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "train", train)
        argv = ["-c", str(CONFIGS / CONFIGS_RUN[which][0]), "--device",
                "cpu", "-i", str(iterations)]
        for ov in RUN + overrides + [f"trainer.save_dir={save_dir}"]:
            argv += ["-a", ov]
        assert p_train.main(argv + list(extra)) == 0
    return made[0]


@pytest.mark.parametrize("which", ["hwr", "auto"])
def test_port_f32_checkpoint_resumes_into_bf16(which, tmp_path,
                                               monkeypatch):
    """``scripts/continue_gan_bf16.sh``'s flow on the port's own run: a
    float32 ``train`` of ``K`` steps, then ``train -r -a
    model.compute_dtype=bfloat16`` one step further.  The resumed state
    (weights, Adam moments and steps, schedule, generator) equals the
    float32 checkpoint bit for bit; the step runs the models in bf16 with
    float32 log-probs into CTC, and every parameter and moment stays
    float32."""
    ovs = CONFIGS_RUN[which][1]
    _cli(which, tmp_path, K, ovs)
    name = _configs(which, tmp_path)[1].name
    saved = torch.load(tmp_path / name / "checkpoint-latest.pt",
                       weights_only=False)
    seen = []
    cls = PORT_TRAINERS[which]
    real = cls.train_step

    def step(self, *a, **kw):
        if not seen:
            seen.append(copy.deepcopy(self.state_dict()))
        return real(self, *a, **kw)
    monkeypatch.setattr(cls, "train_step", step)
    spy = _CtcSpy(monkeypatch, PORT_MODULES[which])
    pt = _cli(which, tmp_path, K + 1, ovs, "-r", "-a",
              "model.compute_dtype=bfloat16")
    assert pt.step == K + 1 and len(seen) == 1
    resumed = seen[0]
    assert resumed["step"] == saved["step"] == K
    for k, v in saved["model"].items():
        assert torch.equal(resumed["model"][k], v), k
    opt = resumed["optimizer"]["state"]
    assert opt.keys() == saved["optimizer"]["state"].keys()
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(opt[i][k], v), (i, k)
    assert resumed["scheduler"] == saved["scheduler"]
    assert torch.equal(resumed["generator"], saved["generator"])
    assert spy.dtypes == [torch.float32]
    _check_dtypes(pt)
    log = json.loads((tmp_path / name / "train_log.json").read_text())
    assert [e["iteration"] for e in log] == [1, 2, 3]
    assert all(np.isfinite(e["loss"]) for e in log)


@pytest.mark.compile
@pytest.mark.parametrize("which", ["hwr", "auto"])
def test_jax_f32_run_resumes_into_bf16(jax_side, which, tmp_path,
                                       monkeypatch):
    """``train -r -a model.compute_dtype=bfloat16`` over a copy of a JAX
    float32 run directory (the step tests' float32 run after ``K`` steps,
    saved by the JAX ``CheckpointManager``): the JAX state bit for bit
    (weights, Adam moments and steps), then step ``K + 1`` in bf16 on the
    step tests' batch: its log-probs (max abs) and gradient (read back
    from JAX's Adam first moments, relative L2) within ``RATIO`` times the
    distance of JAX's float32 continuation from its bf16 one (the loss,
    one scalar, is no yardstick: see the step tests), and the parameters
    after within Adam's bound of JAX's bf16 ones."""
    run = jax_side.runs[which]
    shutil.copytree(run["root"] / run["name"], tmp_path / run["name"])
    ovs = [] if which == "hwr" else [f"autoencoder.hwr_classes={NC}"]
    pt = _cli(which, tmp_path, K, ovs, "-r", "-a",
              "model.compute_dtype=bfloat16")
    assert pt.step == K
    convert = CONVERT[which]
    before = run["before"]
    weights = convert(before.params)
    mu0, nu0 = (convert(getattr(before.opt_state[0], k))
                for k in ("mu", "nu"))
    sd = pt.optimizer.state_dict()["state"]
    for i, (n, p) in enumerate(pt.model.named_parameters()):
        assert torch.equal(p.detach(), weights[n]), n
        assert torch.equal(sd[i]["exp_avg"], mu0[n]), n
        assert torch.equal(sd[i]["exp_avg_sq"], nu0[n]), n
        assert sd[i]["step"].item() == K
    pt.augmentation = None              # as the step tests' trainers
    _port_no_dropout(pt)
    spy = _CtcSpy(monkeypatch, PORT_MODULES[which])
    got = pt.train_step(*_batch(which))
    if which == "hwr":
        got = dict(zip(("loss", "logp"), got))
    s16, s32 = (run["steps"][d] for d in ("bfloat16", "float32"))
    ratios = {}
    a, b = s16["out"]["logp"], s32["out"]["logp"]
    _within(_max_abs(got["logp"].numpy(), a), _max_abs(a, b), "logp",
            ratios)
    assert np.isfinite(float(got["loss"]))
    b1 = pt.cfg.optimizer.betas[0]
    names = [n for n, _ in pt.model.named_parameters()]
    g16, g32 = ({n: (convert(s["mu"])[n] - b1 * mu0[n]) / (1 - b1)
                 for n in names} for s in (s16, s32))
    _within(_rel_l2([p.grad.numpy() for _, p in pt.model.named_parameters()],
                    [g16[n].numpy() for n in names]),
            _rel_l2([g32[n].numpy() for n in names],
                    [g16[n].numpy() for n in names]), "gradient L2", ratios)
    print(f"{which} resumed bf16 step ratios:", json.dumps(
        {k: round(float(v), 3) for k, v in ratios.items()}))
    lr = pt.optimizer.param_groups[0]["lr"]
    bound = 2 * lr * _adam_step_bound(*pt.cfg.optimizer.betas, K + 1) + 1e-7
    want = convert(s16["params"])
    for n, p in pt.model.named_parameters():
        assert (p.detach() - want[n]).abs().max() <= bound, n
    assert spy.dtypes == [torch.float32]
    _check_dtypes(pt)
