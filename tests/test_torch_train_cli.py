"""Port parity for training from a config: ``make_batcher`` on the mini-IAM
fixture and the synthetic corpus, the reference-schema translation and the
overrides against the JAX package's, one HWR step from ``load_config`` +
``make_batcher`` in both packages, and the port's ``train`` CLI on the CPU
(HWR with resume and its refusals, then a GAN run on the two pretrained
checkpoints)."""

import json
import pathlib
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from handwriting_line_generation_tpu.config import (
    apply_overrides as j_overrides, config_from_reference as j_from_ref,
    load_config as j_load,
)
from handwriting_line_generation_tpu.data import datasets as JD
from handwriting_line_generation_tpu.training.hwr_trainer import (
    HWRState, HWRTrainer as JHWRTrainer,
)
from handwriting_line_generation_tpu_torch import train as cli
from handwriting_line_generation_tpu_torch.config import (
    apply_overrides, config_from_reference, load_config,
)
from handwriting_line_generation_tpu_torch.data import datasets as PD
from handwriting_line_generation_tpu_torch.init import init_hwr_params
from handwriting_line_generation_tpu_torch.ops import augment as p_augment
from handwriting_line_generation_tpu_torch.training import hwr_trainer
from handwriting_line_generation_tpu_torch.utils.checkpoint import load_meta

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "fixtures" / "mini_iam"
CONFIGS = REPO / "configs"
FG_SHARE = 0.01                     # fg-mask pixels allowed to differ
LEVEL = 1.0 / 128 + 1e-6            # one grey level, normalized


def _both(name, overrides):
    """The JAX and port configs of ``configs/<name>`` with ``overrides``."""
    path = str(CONFIGS / name)
    return (j_overrides(j_load(path), overrides),
            apply_overrides(load_config(path), overrides))


BATCHERS = {
    "iam_lines": ("iam_hwr.json", [f"data.data_dir={FIXTURE}",
                                   "data.batch_size=4"]),
    "iam_author_fg": ("iam_gan_paper.json", [f"data.data_dir={FIXTURE}"]),
    "synthetic_v3": ("syn_hwr3.json", ["data.synthetic_authors=3",
                                       "data.synthetic_lines=3",
                                       "data.batch_size=4"]),
}


@pytest.mark.parametrize("which", sorted(BATCHERS))
def test_make_batcher_matches_jax(which):
    jcfg, pcfg = _both(*BATCHERS[which])
    for split in ("train", "valid"):
        jb, pb = JD.make_batcher(jcfg.data, split), \
            PD.make_batcher(pcfg.data, split)
        assert type(pb).__name__ == type(jb).__name__
        assert len(pb) == len(jb)
        for want, got in zip(jb.batches(np.random.default_rng(3)),
                             pb.batches(np.random.default_rng(3))):
            assert sorted(got) == sorted(want)
            for k in ("label", "label_lengths", "width"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k in ("gt", "author", "rid", "a_batch_size"):
                assert got[k] == want[k], k
            assert got["image"].shape == want["image"].shape
            assert np.abs(got["image"] - want["image"]).max() <= LEVEL
            if "fg_mask" in want:
                share = float((got["fg_mask"] != want["fg_mask"]).mean())
                assert share <= FG_SHARE, share


# reference-schema configs (the published ``cf_*.json`` layout)
REF_HWR = {
    "name": "IAM_hwr_cnnOnly_batchnorm_aug", "arch": "HWWithStyle",
    "model": {"num_class": 80, "hwr": "CNNOnly batchnorm",
              "style": "none", "generator": "none"},
    "optimizer_type": "Adam",
    "optimizer": {"lr": 0.001, "weight_decay": 0},
    "data_loader": {"data_set_name": "HWDataset", "data_dir": "../data/IAM/",
                    "batch_size": 16, "img_height": 64, "max_width": 1300,
                    "char_file": "../data/IAM_char_set.json",
                    "augmentation": "warp", "shuffle": True},
    "trainer": {"class": "HWRWithSynthTrainer", "iterations": 100000,
                "save_dir": "saved/", "val_step": 1000, "save_step": 25000,
                "save_step_minor": 250, "log_step": 100},
}
REF_AUTO = {
    "name": "IAM_auto_2tight_newCTC", "arch": "Autoencoder",
    "model": {"type": "2tight", "hwr": 80},
    "optimizer_type": "Adam",
    "optimizer": {"lr": 0.0002, "betas": [0.5, 0.999]},
    "loss": {"auto": "L1Loss", "recog": "CTCLoss"},
    "loss_weights": {"auto": 1, "recog": 1},
    "data_loader": {"data_set_name": "AuthorHWDataset",
                    "data_dir": "../data/IAM/", "batch_size": 28,
                    "a_batch_size": 1, "img_height": 64, "max_width": 1300},
    "trainer": {"class": "AutoTrainer", "iterations": 60000,
                "save_step": 10000, "val_step": 5000, "log_step": 250},
}
REF_GAN = {
    "name": "IAM_GAN_paper", "arch": "HWWithStyle",
    "model": {"num_class": 80, "hwr": "CNNOnly batchnorm",
              "pretrained_hwr": "saved/IAM_hwr/checkpoint-latest.pth",
              "hwr_frozen": True, "style": "new char",
              "style_dim": 128, "style_extractor_dim": 64,
              "char_style_extractor_dim": 128, "char_style_window": 2,
              "style_norm": "group", "style_activ": "relu",
              "style_global_pool": True, "average_found_char_style": 1.0,
              "generator": "PureGen", "gen_dim": 256,
              "gen_append_style": True, "discriminator": "charCondAP no style, "
              "no global, no cond, use low, no med", "disc_dim": 64,
              "spacer": "duplicates", "spacer_dim": 128,
              "count_std": 0.00000001, "dup_std": 0.000000001},
    "optimizer_type": "Adam",
    "optimizer": {"lr": 0.0002, "betas": [0.5, 0.999]},
    "optimizer_type_discriminator": "Adam",
    "optimizer_discriminator": {"lr": 0.0002, "betas": [0.5, 0.999]},
    "loss": {"auto": "L1Loss", "count": "MSELoss", "reconRecog": "CTCLoss",
             "genRecog": "CTCLoss"},
    "loss_weights": {"auto": 0.5, "count": 0.5, "reconRecog": 0.000001,
                     "genRecog": 0.0001, "discriminator": 1, "generator": 1},
    "data_loader": {"data_set_name": "AuthorHWDataset",
                    "data_dir": "../data/IAM/", "batch_size": 2,
                    "a_batch_size": 2, "img_height": 64, "max_width": 1300,
                    "fg_masks_dir": "../data/IAM_fg", "augmentation": "affine"},
    "trainer": {"class": "HWWithStyleTrainer", "iterations": 175000,
                "text_data": "../data/english_text.txt",
                "curriculum": {"0": [["count"], ["no-step", "gen"],
                                     ["auto", "auto-gen"], ["disc"]]},
                "balance_loss": "sign_preserve_var",
                "balance_var_x": {"0": [0.6, 0.5, 0.4, 0.75]},
                "interpolate_gen_styles": "extra-0.5",
                "encoder_weights": "saved/IAM_auto/checkpoint-latest.pth",
                "use_learning_schedule": False},
}


@pytest.mark.parametrize("ref", [REF_HWR, REF_AUTO, REF_GAN],
                         ids=["hwr", "auto", "gan"])
def test_config_from_reference_matches_jax(ref, tmp_path):
    assert config_from_reference(ref).to_dict() == \
        j_from_ref(ref).to_dict()
    path = tmp_path / "ref.json"
    path.write_text(json.dumps(ref))
    assert load_config(str(path)).to_dict() == \
        j_load(str(path)).to_dict()


@pytest.mark.parametrize("overrides", [
    ["optimizer.lr=0.0001", "trainer.loss_weights.auto=0.25"],
    ["data.width_buckets=[128,256]", "trainer.curriculum={\"0\": [[\"auto\"]]}"],
    ["trainer.swa=true", "data.shuffle=False", "trainer.iterations=7"],
    ["model=generator=dim=64", "data.text_data=", "name=run2"],
], ids=["floats", "json", "booleans", "nested"])
def test_apply_overrides_matches_jax(overrides):
    jcfg, pcfg = _both("iam_gan_paper.json", overrides)
    assert pcfg.to_dict() == jcfg.to_dict()


def test_apply_overrides_missing_field_raises():
    for overrides, cfg in ((j_overrides, j_load(str(CONFIGS / "iam_hwr.json"))),
                           (apply_overrides,
                            load_config(str(CONFIGS / "iam_hwr.json")))):
        with pytest.raises(AttributeError, match="no config field"):
            overrides(cfg, ["trainer.no_such_field=1"])
        with pytest.raises(ValueError, match="no '='"):
            overrides(cfg, ["trainer.iterations"])


@pytest.mark.compile
def test_hwr_step_from_config_matches_jax(monkeypatch):
    """The slice as a whole: ``load_config`` + ``make_batcher`` over the
    fixture, the first batch of ``forever(..., seed=trainer.seed)`` in each
    package (the port's CLI hands its trainer that iterator from batch 0),
    quantized to u8 as both loops do, the same weights, the JAX step's
    warp-augmentation draws injected into the port's: the same loss."""
    overrides = [f"data.data_dir={FIXTURE}", "data.batch_size=4"]
    jcfg, pcfg = _both("iam_hwr.json", overrides)
    jbatch = next(JD.forever(JD.make_batcher(jcfg.data, "train"),
                             seed=jcfg.trainer.seed))
    pbatch = next(PD.forever(PD.make_batcher(pcfg.data, "train"),
                             seed=pcfg.trainer.seed))
    assert pbatch["gt"] == jbatch["gt"]
    tree = init_hwr_params(pcfg.model.hwr, 80, seed=0)

    image = JD.quantize_image_u8(jbatch["image"])
    # the JAX step's draws: split(rng) -> aug key -> (brightness, warp)
    _, aug_key = jax.random.split(jax.random.PRNGKey(1))
    k1, k2 = jax.random.split(aug_key)
    B, H, W = image.shape[:3]
    shifts = [[float(jax.random.normal(a)), float(jax.random.normal(b))]
              for a, b in (jax.random.split(k) for k in
                           jax.random.split(k1, B))]
    offsets = np.array(jax.random.normal(k2, (B, H // 12 + 2,
                                              W // 12 + 2, 2)))
    draws = {"shifts": torch.tensor(shifts),
             "offsets": torch.from_numpy(offsets)}

    jt = JHWRTrainer(jcfg)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = HWRState(step=jnp.zeros((), jnp.int32), params=params,
                     opt_state=jt.tx.init(params),
                     rng=jax.random.PRNGKey(1))
    _, out = jt.train_step(state, jnp.asarray(image),
                           jnp.asarray(jbatch["label"]),
                           jnp.asarray(jbatch["label_lengths"]),
                           jnp.asarray(jbatch["width"]))

    def injected(kind, img, fg, generator):
        return p_augment.apply_augmentation(kind, img, fg, generator,
                                            draws=draws)
    monkeypatch.setattr(hwr_trainer, "apply_augmentation", injected)
    pt = hwr_trainer.HWRTrainer(pcfg, device="cpu")
    pt.init_state(seed=0, params=tree)
    metrics = pt._train_step(iter([pbatch]), 1, log_step=False)
    np.testing.assert_allclose(float(metrics["loss"]), float(out["loss"]),
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pulled", [0, 2])
def test_prefetcher_close_stops_its_thread(pulled):
    """``close`` ends the worker whether its queue is full or being
    drained, and the iterator ends with it."""
    fetched = PD.Prefetcher(iter(range(10 ** 9)), depth=2)
    assert [next(fetched) for _ in range(pulled)] == list(range(pulled))
    fetched.close()
    assert not fetched._thread.is_alive()
    assert list(fetched) == []


def _cli(config, save_dir, *extra, iterations=None):
    argv = ["-c", str(CONFIGS / config), "--device", "cpu",
            "-a", f"data.data_dir={FIXTURE}", "-a",
            f"trainer.save_dir={save_dir}", "-a", "data.max_width=300",
            *extra]
    if iterations:
        argv += ["-i", str(iterations)]
    return cli.main(argv)


def _log(run_dir):
    return json.loads((run_dir / "train_log.json").read_text())


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """HWR (2 steps and a validation) and autoencoder (2 steps) runs of
    the CLI over the fixture: the checkpoints the GAN run loads."""
    root = tmp_path_factory.mktemp("cli")
    assert _cli("iam_hwr.json", root, "-a", "data.batch_size=4",
                "-a", "trainer.log_step=1", "-a", "trainer.val_step=2",
                "-a", "trainer.save_step_minor=2", iterations=2) == 0
    assert _cli("iam_auto_2tight.json", root, "-a", "data.batch_size=4",
                "-a", "trainer.log_step=1", "-a", "trainer.val_step=0",
                "-a", "trainer.save_step_minor=2", iterations=2) == 0
    return root


@pytest.mark.compile
def test_cli_hwr_writes_log_and_checkpoint(pretrained):
    run = pretrained / "iam_hwr"
    log = _log(run)
    steps = [e for e in log if "val_CER" not in e]
    assert [e["iteration"] for e in steps] == [1, 2]
    assert all(np.isfinite(e["loss"]) for e in steps)
    assert np.isfinite(log[-1]["val_CER"]) and log[-1]["iteration"] == 2
    assert load_meta(str(run), "checkpoint-latest")["iteration"] == 2
    assert (run / "checkpoint-latest.pt").exists()
    assert (pretrained / "iam_auto_2tight" / "checkpoint-latest.pt").exists()


@pytest.mark.compile
def test_cli_resume_and_refusals(pretrained, tmp_path, capsys):
    run = tmp_path / "iam_hwr"
    shutil.copytree(pretrained / "iam_hwr", run)
    extra = ("-a", "data.batch_size=4", "-a", "trainer.log_step=1",
             "-a", "trainer.val_step=0", "-a", "trainer.save_step_minor=1")
    before = set(threading.enumerate())
    with pytest.raises(RuntimeError, match="checkpoint"):
        _cli("iam_hwr.json", tmp_path, *extra, iterations=3)
    assert _cli("iam_hwr.json", tmp_path, "-r", *extra, iterations=3) == 0
    assert set(threading.enumerate()) <= before      # prefetchers stopped
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert [e["iteration"] for e in lines] == [3]
    assert load_meta(str(run), "checkpoint-latest")["iteration"] == 3
    with pytest.raises(ValueError, match="fused_epilogue"):
        _cli("iam_hwr.json", tmp_path / "x", "-a",
             "model.generator.fused_epilogue=true")


GAN_SHRINK = ["model.generator.dim=64", "model.style.style_dim=32",
              "model.style.dim=16", "model.style.char_dim=16",
              "model.style.char_capacity=4", "model.discriminator.dim=16",
              "model.spacer.dim=128"]


@pytest.mark.compile
def test_cli_gan_run_on_pretrained(pretrained, tmp_path):
    """A 7-lesson paper cycle with the recognizer and the perceptual
    encoder of the two runs before, widths shrunk, the built-in text."""
    extra = ["-a", f"model.pretrained_hwr={pretrained}/iam_hwr/"
                   "checkpoint-latest",
             "-a", f"trainer.encoder_weights={pretrained}/iam_auto_2tight/"
                   "checkpoint-latest",
             "-a", "data.text_data=", "-a", "trainer.log_step=7",
             "-a", "trainer.val_step=0", "-a", "trainer.save_step_minor=7"]
    for ov in GAN_SHRINK:
        extra += ["-a", ov]
    assert _cli("iam_gan_paper.json", tmp_path, *extra, iterations=7) == 0
    last = _log(tmp_path / "iam_gan_paper")[-1]
    for k in ("autoLoss", "countLoss", "discriminatorLoss", "generatorLoss"):
        assert np.isfinite(last[k]), k
    assert (tmp_path / "iam_gan_paper" / "checkpoint-latest.pt").exists()
