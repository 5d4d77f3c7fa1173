"""The plain reference against the program's plain path, on the CPU at small
sizes, on the same seeded weights and inputs: generation, extraction and
one GAN lesson of each kind."""

import numpy as np
import pytest
import torch

from harness import dry, inputs, registry, weights
from reference import build as ref_build
from reference import extraction as ref_ext
from reference import generation as ref_gen
from reference.charset import get_charset


def _small(cfg_name: str, cell: str):
    wl = registry.workload(cell)
    return dry.shrunk_config(registry.config(cfg_name),
                             wl["dry_run"]["config"])


def _program_model(cfg_file, seed):
    from handwriting_line_generation_tpu_torch.config import config_from_dict
    from handwriting_line_generation_tpu_torch.models.hw_with_style import \
        HWWithStyle
    cfg = config_from_dict(cfg_file["config"])
    cfg.model.compute_dtype = "float32"
    cfg.model.generator.fused_epilogue = False
    m = HWWithStyle(cfg.model)
    weights.fill(m, seed)
    return cfg, m.eval()


def test_weights_are_the_same_on_both_sides():
    cfg_file = _small("iam_gan_paper", "gan_paper_b4")
    _, prog = _program_model(cfg_file, 5)
    ref = ref_build.model(cfg_file, 5, "cpu")
    ps, rs = prog.state_dict(), ref.state_dict()
    assert list(ps) == list(rs)
    for k in ps:
        assert torch.equal(ps[k], rs[k]), k
    assert weights.fill(prog, 5) == weights.fill(ref, 5) > 0


@pytest.mark.parametrize("fused", [False, True])
def test_generation_request(fused):
    """``GenerationSession.render_tensor`` against the reference's
    request, f32; ``fused`` runs the program's epilogue entry (its plain
    version on the CPU)."""
    from handwriting_line_generation_tpu_torch.inference.generate import \
        GenerationSession
    cfg_file = _small("paper_gen_bf16", "gen_paper_b512")
    cfg, prog = _program_model(cfg_file, 21)
    prog.generator.fused_epilogue = fused
    charset = get_charset("iam")
    rng = np.random.default_rng(0)
    texts = inputs.texts(rng, charset.chars, 5, 4, 9)
    styles = rng.standard_normal((5, cfg.model.style.style_dim)).astype(
        np.float32)
    from handwriting_line_generation_tpu_torch.charset import IAM_CHARSET
    s = GenerationSession(prog, IAM_CHARSET, device="cpu")
    img = s.render_tensor(texts, styles, seed=77, spaced_len=40)
    ref = ref_build.model(cfg_file, 21, "cpu")
    out = ref_gen.request(ref, charset, texts, styles, 77, 40,
                          torch.float32, "cpu")
    assert out["image"].shape == img.shape
    # the program's fused entry normalizes with a one-pass variance
    assert (out["image"] - img).abs().max() < (1e-4 if fused else 1e-5)
    gaps = ref_gen.judge(ref, charset, texts, styles, 77, 40, torch.float32,
                         out, "cpu")
    assert gaps == {"count_gap": 0.0, "spaced_mismatch": 0.0,
                    "image_gap": 0.0}


def test_extraction_request():
    from handwriting_line_generation_tpu_torch.inference.styles import \
        StyleExtractor
    from handwriting_line_generation_tpu_torch.ops.augment import \
        dequantize_image
    cfg_file = _small("iam_gan_paper", "extract_paper_b64")
    _, prog = _program_model(cfg_file, 8)
    image, _, _, width = inputs.glyph_lines(np.random.default_rng(1), 4,
                                            128, 24)
    image, width = torch.from_numpy(image), torch.from_numpy(width)
    x = dequantize_image(image, width)
    frames = torch.clamp((width + 3) // 4, 1, 128 // 4)
    style, pred = StyleExtractor(prog, device="cpu").extract(x, frames, 2)
    ref = ref_build.model(cfg_file, 8, "cpu")
    out = ref_ext.request(ref, image, width, 2)
    assert (out["styles"] - style[::2]).abs().max() < 1e-5
    assert (out["pred"] - pred).abs().max() < 1e-5


def test_gan_lessons():
    """The first four lessons (count, no-step gen, auto, disc) of the
    program's ``GanTrainer`` and of the reference from one seed: losses,
    the first gradient and the change, by leaf."""
    r = dry.run("gan_paper_b4", seed=17, seconds=0.0)
    c = r["checks"]
    assert c["loss_gap"]["value"] < 1e-3
    assert c["grad_gap"]["value"] < 1e-4
    # Adam turns a gradient entry near its eps into a step of any size up
    # to lr, so the programs' CTCs (a recursion here, PyTorch's in the
    # reference) move such entries apart
    assert c["change_gap"]["value"] < 1e-2
