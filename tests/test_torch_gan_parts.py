"""Port parity for the GAN trainer's parts: losses, the curriculum, the
text sampler, parameter partitions, the clipped partition optimizers,
saved-gradient balancing and the style bank, against the JAX package on
the same numpy inputs.  Tolerances: float32 losses within rtol 1e-6,
balancing and the bank within 1e-6 of each tensor's largest entry, Adam
within 1e-6 absolute (1e-4 of an update of ~lr = 1e-2: a few float32 ulps
of the weights); the rest exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from handwriting_line_generation_tpu.charset import IAM_CHARSET as J_CHARSET
from handwriting_line_generation_tpu.config import OptimConfig as JOptim
from handwriting_line_generation_tpu.data.text_data import \
    TextSampler as JTextSampler
from handwriting_line_generation_tpu.training import losses as JL
from handwriting_line_generation_tpu.training import train_state as JT
from handwriting_line_generation_tpu.training.curriculum import \
    Curriculum as JCurriculum
from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
from handwriting_line_generation_tpu_torch.config import (
    DiscriminatorConfig, GeneratorConfig, HWRConfig, ModelConfig,
    OptimConfig, SpacerConfig, StyleConfig, load_config,
)
from handwriting_line_generation_tpu_torch.convert import convert_params
from handwriting_line_generation_tpu_torch.data.text_data import TextSampler
from handwriting_line_generation_tpu_torch.init import (
    init_params, init_spectral,
)
from handwriting_line_generation_tpu_torch.models.hw_with_style import \
    HWWithStyle
from handwriting_line_generation_tpu_torch.training import losses as PL
from handwriting_line_generation_tpu_torch.training import train_state as PT
from handwriting_line_generation_tpu_torch.training.curriculum import \
    Curriculum
from handwriting_line_generation_tpu_torch.training.gan_trainer import (
    REPO_ROOT, GanTrainer, resolve_text_data,
)

PAPER = {"0": [["count"], ["no-step", "gen"], ["auto", "auto-gen"],
               ["disc"], ["no-step", "gen"], ["auto", "auto-gen"],
               ["disc"]]}
STAGED = {"0": [[2, "auto"], ["disc", "sample-disc"],
                ["auto", "auto-style"]],
          "40": [["gen", "no-step"], [3, "auto", "style-ex-only"],
                 ["split-style"], ["auto", "style-super", "triplet-x"]],
          "15": [["count"], ["valid-only"]]}


def _max_rel(got, want):
    want = np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    return np.abs(np.asarray(got, np.float64) - want).max() / scale


def test_losses_match_jax():
    rng = np.random.default_rng(0)
    real = [rng.normal(size=(3, n)).astype(np.float32) for n in (5, 2)]
    fake = [rng.normal(size=(3, n)).astype(np.float32) for n in (5, 2)]
    t = lambda xs: [torch.from_numpy(x) for x in xs]
    np.testing.assert_allclose(
        float(PL.disc_hinge_loss(t(real), t(fake))),
        float(JL.disc_hinge_loss(real, fake)), rtol=1e-6)
    np.testing.assert_allclose(float(PL.gen_adv_loss(t(fake))),
                               float(JL.gen_adv_loss(fake)), rtol=1e-6)
    mu, ls = (rng.normal(size=(4, 6)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        float(PL.vae_kl(torch.from_numpy(mu), torch.from_numpy(ls))),
        float(JL.vae_kl(mu, ls)), rtol=1e-6)
    a, b = mu, ls
    for name in ("L1Loss", "MSE", "MSELoss"):
        np.testing.assert_allclose(
            float(PL.get_loss(name)(torch.from_numpy(a), torch.from_numpy(b))),
            float(JL.get_loss(name)(a, b)), rtol=1e-6)


@pytest.mark.parametrize("desc", [PAPER, STAGED, {}], ids=["paper", "staged",
                                                          "empty"])
def test_curriculum_matches_jax(desc):
    j, p = JCurriculum(desc), Curriculum(desc)
    for i in range(0, 60):
        assert p.get_lesson(i) == j.get_lesson(i), i
        assert p.lesson_key(i) == j.lesson_key(i), i
    assert p.distinct_lessons() == j.distinct_lessons()
    for flag in ("need_sep_gen_opt", "need_sep_style_ex_opt",
                 "need_style_in_disc", "sample_disc", "valid_tags",
                 "eval_tags", "stages"):
        assert getattr(p, flag) == getattr(j, flag), flag


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, max_len=96),
                                dict(seed=1, words=True),
                                dict(seed=2, character_balance=True,
                                     min_len=1, max_len=5)],
                         ids=["paper", "long", "words", "balance"])
def test_text_sampler_matches_jax_bit_for_bit(kw):
    j = JTextSampler(J_CHARSET, batch_size=4, **kw)
    p = TextSampler(IAM_CHARSET, batch_size=4, **kw)
    assert p.text == j.text
    for label_len in (None, 96, 5):
        a, b = p.get_batch(label_len), j.get_batch(label_len)
        assert a["gt"] == b["gt"]
        for k in ("label", "label_lengths"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def _small_model_cfg(**disc):
    """The recognizer is the full-size ``cnn_only`` one (its width is not
    configurable)."""
    return ModelConfig(
        hwr=HWRConfig(kind="cnn_only", norm="group"),
        style=StyleConfig(style_dim=8, dim=4, char_dim=4, char_capacity=2),
        generator=GeneratorConfig(dim=32), spacer=SpacerConfig(dim=8),
        discriminator=DiscriminatorConfig(dim=4, **disc))


@pytest.mark.parametrize("kw", [dict(hwr_frozen=True),
                                dict(hwr_frozen=False),
                                # the discriminator's other leaves
                                dict(hwr_frozen=True,
                                     disc=dict(small=True, use_global=True,
                                               cond=True))])
def test_partitions_match_jax_leaf_for_leaf(kw):
    """Each flax leaf filled with its index goes through the converter, so
    every port parameter names the leaf it came from."""
    kw = dict(kw)
    cfg = _small_model_cfg(**kw.pop("disc", {}))
    params = init_params(cfg, seed=0)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(a.shape, i, np.float32)
                  for i, a in enumerate(leaves)])
    sd = convert_params(tagged, init_spectral(cfg))
    labels_j = jax.tree_util.tree_leaves(JT.partition_params(params, **kw))
    with torch.device("meta"):                   # names only
        names = [n for n, _ in HWWithStyle(cfg).named_parameters()]
    assert len(names) == len(leaves)
    labels_p = PT.partition_params(names, **kw)
    seen = set()
    for name, label in zip(names, labels_p):
        idx = int(sd[name].reshape(-1)[0])
        assert (sd[name] == idx).all()
        assert label == labels_j[idx], name
        seen.add(idx)
    assert seen == set(range(len(leaves)))
    assert set(labels_p) <= set(PT.PARTITIONS)


def _tree_and_list(rng, shapes):
    tree = {k: rng.normal(size=s).astype(np.float32)
            for k, s in shapes.items()}
    return tree, [torch.from_numpy(tree[k]) for k in sorted(shapes)]


def test_balance_and_merge_matches_jax():
    """Including a tensor whose D is all zero (it takes the mean of the
    non-zero mean|D|) and a group that is all zero (adds nothing)."""
    rng = np.random.default_rng(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2), "d": (7,)}
    d_tree, d_list = _tree_and_list(rng, shapes)
    d_tree["b"][:] = 0
    d_list[1].zero_()
    groups = [_tree_and_list(rng, shapes) for _ in range(3)]
    zero = ({k: np.zeros(s, np.float32) for k, s in shapes.items()},
            [torch.zeros(s) for _, s in sorted(shapes.items())])
    groups.insert(1, zero)
    groups[2][0]["c"][:] = 0
    groups[2][1][2].zero_()
    mults = [0.6, 0.5, 0.4, 0.75]
    want = JT.balance_and_merge(d_tree, [g[0] for g in groups], mults)
    got = PT.balance_and_merge(d_list, [g[1] for g in groups], mults)
    for k, g in zip(sorted(shapes), got):
        assert _max_rel(g.numpy(), want[k]) <= 1e-6, k
    sched = {"0": [0.6, 0.5, 0.4, 0.75], "100": [0.3], "50": 0.2}
    for it in (0, 49, 50, 99, 100, 10 ** 6):
        assert PT.multipliers_at(sched, it) == JT.multipliers_at(sched, it)
    assert PT.multipliers_at({}, 5) == JT.multipliers_at({}, 5)
    np.testing.assert_allclose(float(PT.global_norm(d_list)),
                               float(optax.global_norm(d_tree)), rtol=1e-6)


@pytest.mark.parametrize("count", [0, 3, 9])
def test_bank_push_and_sample_match_jax(count):
    """A push past the end wraps around; a sample with the draws of the
    JAX key, injected."""
    rng = np.random.default_rng(count)
    size, D, B = 6, 5, 4
    bank = rng.normal(size=(size, D)).astype(np.float32)
    styles = rng.normal(size=(2, D)).astype(np.float32)
    jb, jc = JT.bank_push(jnp.asarray(bank), jnp.asarray(count),
                          jnp.asarray(styles))
    pb, pc = PT.bank_push(torch.from_numpy(bank.copy()), count,
                          torch.from_numpy(styles))
    assert pc == int(jc)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    key = jax.random.PRNGKey(count + 10)
    k1, k2, k3 = jax.random.split(key, 3)
    limit = min(max(count, 1), size)
    draws = (np.asarray(jax.random.randint(k1, (B, 2), 0, limit)),
             np.asarray(jax.random.uniform(k2, (B, 1), minval=-0.5,
                                           maxval=1.5)),
             np.asarray(jax.random.normal(k3, (B, D))))
    want = JT.bank_sample(jnp.asarray(bank), jnp.asarray(count), key, B,
                          -0.5, 1.5, D)
    got = PT.bank_sample(torch.from_numpy(bank), count, B, -0.5, 1.5, D,
                         draws=tuple(torch.from_numpy(d) for d in draws))
    assert _max_rel(got.numpy(), want) <= 1e-6
    # the draws from a generator keep their ranges
    g = PT.bank_sample(torch.from_numpy(bank), count, 64, -0.5, 1.5, D,
                       generator=torch.Generator().manual_seed(0))
    assert g.shape == (64, D) and bool(torch.isfinite(g).all())


def test_clipped_partition_adam_matches_optax():
    """Two updates of the main and disc optimizers: element clip at ±2,
    Adam over their own partitions only, frozen never stepped; a main leaf
    that gets no gradient in the second update still moves by its first
    moment, as optax's does with a zero one."""
    rng = np.random.default_rng(2)
    shapes = {"discriminator/w": (3, 3), "generator/a": (4,),
              "generator/zero": (2, 3), "hwr/w": (5,), "spacer/s": (3,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    labels = {k: JT.partition_label((k,), hwr_frozen=True) for k in params}
    jcfg = JOptim(lr=1e-2, betas=(0.5, 0.999))
    main_tx, disc_tx = JT.make_optimizers(labels, jcfg, jcfg, grad_clip=2.0)
    names = sorted(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in names]
    plabels = PT.partition_params([k.replace("/", ".") for k in names],
                                  hwr_frozen=True)
    pcfg = OptimConfig(lr=1e-2, betas=(0.5, 0.999))
    main, disc = PT.make_optimizers(tparams, plabels, pcfg, pcfg,
                                    grad_clip=2.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    states = {"main": main_tx.init(jp), "disc": disc_tx.init(jp)}
    for step in range(2):
        for which, tx, opt in (("main", main_tx, main),
                               ("disc", disc_tx, disc)):
            grads = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
                     for k, s in shapes.items()}
            if step == 1:
                grads["generator/zero"][:] = 0
            upd, states[which] = tx.update(
                {k: jnp.asarray(v) for k, v in grads.items()},
                states[which], jp)
            jp = optax.apply_updates(jp, upd)
            tg = [torch.from_numpy(grads[k]) for k in names]
            if step == 1:
                tg[names.index("generator/zero")] = None   # no gradient
            opt.step(tg)
            for k, p in zip(names, tparams):
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jp[k]), rtol=0,
                                           atol=1e-6, err_msg=(step, k))
    moved = {k: not np.array_equal(np.asarray(jp[k]), params[k])
             for k in names}
    assert moved == {"discriminator/w": True, "generator/a": True,
                     "generator/zero": True, "hwr/w": False,
                     "spacer/s": True}


def test_sep_optimizers_match_optax():
    """Two updates of the generator-only and style-extractor-only
    optimizers (``auto-style`` / ``style-ex-only`` lessons): element clip at
    ±2, Adam at a constant rate over the parameters whose name holds the
    prefix, the rest never stepped."""
    rng = np.random.default_rng(3)
    shapes = {"discriminator/w": (3,), "generator/a": (4,), "hwr/w": (5,),
              "style_extractor/b": (2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jcfg = JOptim(lr=1e-2, betas=(0.5, 0.999))
    txs = JT.make_sep_optimizers(params, jcfg, grad_clip=2.0)
    names = sorted(params)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy()))
               for k in names]
    opts = PT.make_sep_optimizers(
        tparams, [k.replace("/", ".") for k in names],
        OptimConfig(lr=1e-2, betas=(0.5, 0.999)), grad_clip=2.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    states = [tx.init(jp) for tx in txs]
    for _ in range(2):
        for i, (tx, opt) in enumerate(zip(txs, opts)):
            grads = {k: (3.0 * rng.normal(size=s)).astype(np.float32)
                     for k, s in shapes.items()}
            upd, states[i] = tx.update(
                {k: jnp.asarray(v) for k, v in grads.items()}, states[i], jp)
            jp = optax.apply_updates(jp, upd)
            opt.step([torch.from_numpy(grads[k]) for k in names])
            for k, p in zip(names, tparams):
                np.testing.assert_allclose(p.detach().numpy(),
                                           np.asarray(jp[k]), rtol=0,
                                           atol=1e-6, err_msg=(i, k))
    moved = {k: not np.array_equal(np.asarray(jp[k]), params[k])
             for k in names}
    assert moved == {"discriminator/w": False, "generator/a": True,
                     "hwr/w": False, "style_extractor/b": True}


def test_text_data_resolves_inside_the_checkout(tmp_path):
    """``data.text_data`` is read relative to the checkout; a path that
    leaves it is refused, an absent one gives the built-in text.  The paper
    config's ``../data/english_text.txt`` is refused; with ``text_data``
    unset its trainer samples what the sampler's built-in text gives."""
    root = tmp_path / "repo"
    (root / "saved").mkdir(parents=True)
    corpus = root / "saved" / "text.txt"
    corpus.write_text("hello world")
    (tmp_path / "data").mkdir()
    outside = tmp_path / "data" / "english_text.txt"
    outside.write_text("beside the checkout")
    r = str(root)
    assert resolve_text_data("saved/text.txt", r) == str(corpus)
    assert resolve_text_data(str(corpus), r) == str(corpus)
    assert resolve_text_data(None, r) is None
    assert resolve_text_data("", r) is None
    with pytest.warns(UserWarning, match="built-in text"):
        assert resolve_text_data("saved/absent.txt", r) is None
    for bad in ("../data/english_text.txt", str(outside),
                "saved/../../data/english_text.txt"):
        with pytest.raises(ValueError, match="outside the checkout"):
            resolve_text_data(bad, r)
    paper = REPO_ROOT + "/configs/iam_gan_paper.json"
    with pytest.raises(ValueError, match="outside the checkout"):
        GanTrainer(load_config(paper), device="cpu")
    cfg = load_config(paper)
    cfg.data.text_data = None
    tr = GanTrainer(cfg, device="cpu")
    want = TextSampler(IAM_CHARSET, batch_size=4, max_len=96,
                       seed=cfg.trainer.seed)
    assert tr.text.text == want.text
    np.testing.assert_array_equal(tr.text.get_batch(96)["label"],
                                  want.get_batch(96)["label"])
