"""Port parity for the modules no repo config reaches: the
``"normalization"`` augmentation (``deskew``, ``skeletonize``,
``normalize_line``) and ``change_thickness``; the ``slow`` partition and
``style_frozen``; Adam7-interlaced PNGs; and the style path in bfloat16,
each against the JAX package (or OpenCV, for the PNG reader) on the same
numpy inputs and draws."""

import struct
import zlib

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import threadpoolctl
import torch

from handwriting_line_generation_tpu.config import OptimConfig as JOptim
from handwriting_line_generation_tpu.ops import augment as JA
from handwriting_line_generation_tpu.training import train_state as JTS
from handwriting_line_generation_tpu_torch.config import OptimConfig
from handwriting_line_generation_tpu_torch.ops import augment as PA
from handwriting_line_generation_tpu_torch.training import train_state as PTS
from handwriting_line_generation_tpu_torch.utils.png import read_png_gray
from test_torch_extract import _batch, _cfgs, _t
from test_torch_char_style import perturb

TOL = dict(rtol=0.0, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's side on one torch thread and one BLAS thread: the
    recurrences and small GEMMs here slow down a hundredfold when several
    test processes oversubscribe the cores with thread pools."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(threads)


def _lines(B=3, H=32, W=96, seed=0):
    """Normalized images (background -1, ink up to +1): slanted strokes
    of random widths and shades, plus a little noise."""
    rng = np.random.default_rng(seed)
    img = -np.ones((B, H, W, 1), np.float32)
    for b in range(B):
        slant = rng.uniform(-0.6, 0.6)
        for _ in range(8):
            y0, x0 = rng.integers(2, H - 10), rng.integers(4, W - 16)
            width = rng.integers(2, 6)
            for y in range(y0, min(H, y0 + rng.integers(6, 16))):
                x = int(x0 + slant * (y - y0))
                img[b, y, max(0, x):min(W, x + width), 0] = \
                    rng.uniform(0.4, 1.0)
    return img + 0.05 * rng.standard_normal(img.shape).astype(np.float32)


# ---------------------------------------------------------------------------
# "normalization" and change_thickness
# ---------------------------------------------------------------------------

def test_deskew_matches_jax():
    """The chosen shear and the resampled image: the candidate slopes come
    from ``linspace`` in each framework (1 ulp apart at most), so the image
    is held to 1e-4, not bit for bit."""
    img = _lines()
    want = np.asarray(jax.jit(JA.deskew)(jnp.asarray(img)))
    got = PA.deskew(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("density", [0.3, 0.6])
def test_skeletonize_is_exact(density):
    """Zhang-Suen thinning deletes pixels sub-pass by sub-pass: the
    skeletons must be equal, pixel for pixel (random maps, and the ink of
    stroke images)."""
    rng = np.random.default_rng(int(density * 10))
    ink = (rng.random((3, 24, 40)) < density).astype(np.int32)
    strokes = (_lines(seed=2)[..., 0] > 0).astype(np.int32)
    for m in (ink, strokes):
        want = np.asarray(jax.jit(JA.skeletonize)(jnp.asarray(m)))
        got = PA.skeletonize(torch.from_numpy(m)).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        assert 0 < got.sum() < m.sum()


def test_normalize_line_and_the_normalization_kind_match_jax():
    """``normalize_line`` on the same input: the skeleton's mask exact,
    the dilated and blurred image within 1e-6; the whole kind (deskew,
    then normalize) through ``apply_augmentation``, no draws, the mask
    and width scale passed through."""
    img = _lines(seed=1)
    want = np.asarray(jax.jit(JA.normalize_line)(jnp.asarray(img)))
    got = PA.normalize_line(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got > -1.0, want > -1.0)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    fg = np.ones_like(img)
    want, wfg, wscale = jax.jit(lambda x, f: JA.apply_augmentation(
        "normalization", x, f, jax.random.PRNGKey(0)))(jnp.asarray(img),
                                                       jnp.asarray(fg))
    got, gfg, gscale = PA.apply_augmentation(
        "normalization", torch.from_numpy(img), torch.from_numpy(fg), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert gfg.numpy().tolist() == np.asarray(wfg).tolist()
    assert float(gscale) == float(wscale) == 1.0


def test_change_thickness_matches_jax():
    """Dilate, erode and keep (sizes 3, -2, 0), shades per sample, the
    box blur and the noise; the JAX draws (a key per sample) injected."""
    img = _lines(seed=3)
    B, H, W, _ = img.shape
    size = np.array([3, -2, 0], np.int32)
    fg = np.array([0.1, 0.3, 0.0], np.float32)
    bg = np.array([0.9, 0.8, 1.0], np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.jit(JA.change_thickness)(
        jnp.asarray(img), jnp.asarray(size), jnp.asarray(fg),
        jnp.asarray(bg), key))
    noise = np.stack([np.asarray(jax.random.normal(k, (H, W, 1)))
                      for k in jax.random.split(key, B)])
    got = PA.change_thickness(torch.from_numpy(img), torch.from_numpy(size),
                              torch.from_numpy(fg), torch.from_numpy(bg),
                              noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    assert not np.allclose(got[0], got[2], atol=0.05)


# ---------------------------------------------------------------------------
# the slow partition and style_frozen
# ---------------------------------------------------------------------------

NAMES = ["generator/blocks/0/conv1/weight", "spacer/convs/0/weight",
         "style_extractor/trunk/conv/weight", "hwr/trunk/convs/0/weight",
         "discriminator/convs/0/weight", "generator/style_mlp/0/bias"]


@pytest.mark.parametrize("hwr_frozen,style_frozen,slow", [
    (True, False, ()), (False, True, ("spacer",)),
    (True, True, ("style_mlp", "discriminator"))])
def test_partition_labels_match_jax(hwr_frozen, style_frozen, slow):
    want = [JTS.partition_label(tuple(n.split("/")), hwr_frozen=hwr_frozen,
                                style_frozen=style_frozen, slow_names=slow)
            for n in NAMES]
    got = PTS.partition_params([n.replace("/", ".") for n in NAMES],
                               hwr_frozen=hwr_frozen,
                               style_frozen=style_frozen, slow_names=slow)
    assert got == want


def test_slow_partition_steps_at_a_tenth_of_the_rate():
    """Three steps of both optimizers (element clip 2, Adam, a cyclic
    schedule) on a tree with every partition: each parameter within 1e-6
    of optax's ``multi_transform`` with the JAX labels; the ``frozen``
    ones unchanged, the ``slow`` ones moved less."""
    rng = np.random.default_rng(0)
    tree = {n.split("/")[0]: {n.split("/")[-2]: rng.standard_normal(
        (3, 4)).astype(np.float32)} for n in NAMES}
    kw = dict(hwr_frozen=True, style_frozen=True, slow_names=("spacer",))
    jlabels = JTS.partition_params(tree, **kw)
    jopt = dict(lr=1e-2, lr_schedule="cyclic", cycle_size=4)
    main_tx, disc_tx = JTS.make_optimizers(jlabels, JOptim(**jopt),
                                           JOptim(**jopt), 2.0, 100)
    names = [f"{k}.{s}" for k, sub in tree.items() for s in sub]
    params = [torch.nn.Parameter(torch.from_numpy(tree[n.split(".")[0]][
        n.split(".")[1]].copy())) for n in names]
    labels = PTS.partition_params(names, **kw)
    assert labels.count("slow") == 1 and labels.count("frozen") == 2
    main, disc = PTS.make_optimizers(params, labels, OptimConfig(**jopt),
                                     OptimConfig(**jopt), 2.0, 100)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    ms, ds = main_tx.init(jp), disc_tx.init(jp)
    main_up, disc_up = jax.jit(main_tx.update), jax.jit(disc_tx.update)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: jnp.asarray(3 * rng.standard_normal(a.shape),
                                  jnp.float32), jp)
        up, ms = main_up(g, ms, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, up)
        up, ds = disc_up(g, ds, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, up)
        grads = [torch.from_numpy(np.array(g[n.split(".")[0]][
            n.split(".")[1]])) for n in names]
        main.step(grads)
        disc.step(grads)
    for n, p in zip(names, params):
        top, sub = n.split(".")
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(jp[top][sub]), rtol=0,
                                   atol=1e-6, err_msg=n)
    moved = {lab: np.abs(p.detach().numpy() - tree[n.split(".")[0]][
        n.split(".")[1]]).max() for n, p, lab in zip(names, params, labels)}
    assert moved["frozen"] == 0.0
    assert 0 < moved["slow"] < 0.2 * moved["main"]


# ---------------------------------------------------------------------------
# Adam7 PNGs
# ---------------------------------------------------------------------------

_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _sub_filtered(rows, bpp):
    """Each row Sub-filtered (type 1) when its index is odd, Up-less None
    otherwise: both kinds of row in every pass."""
    out = []
    for r, row in enumerate(rows):
        row = row.astype(np.int64)
        if r % 2:
            left = np.concatenate([np.zeros(bpp, np.int64), row[:-bpp]])
            out.append(b"\x01" + ((row - left) & 0xFF).astype(
                np.uint8).tobytes())
        else:
            out.append(b"\x00" + row.astype(np.uint8).tobytes())
    return b"".join(out)


def _adam7_png(arr, ctype):
    """An 8-bit Adam7 PNG of ``arr`` ``[H, W, ch]`` uint8 (grey: ch 1,
    RGB: ch 3): each pass's sub-image filtered and appended in order."""
    H, W, ch = arr.shape
    data = b""
    for y0, x0, dy, dx in _ADAM7:
        sub = arr[y0::dy, x0::dx]
        if sub.size:
            data += _sub_filtered(sub.reshape(sub.shape[0], -1), ch)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0,
                                          1))
            + _chunk(b"IDAT", zlib.compress(data))
            + _chunk(b"IEND", b""))


@pytest.mark.parametrize("H,W,ctype", [(13, 11, 0), (1, 1, 0), (5, 3, 0),
                                       (17, 9, 2), (8, 8, 2)])
def test_read_png_decodes_adam7_as_cv2(tmp_path, H, W, ctype):
    """Sizes that leave some passes empty (1 x 1, 5 x 3), grey and RGB."""
    rng = np.random.default_rng(H * W + ctype)
    arr = rng.integers(0, 256, (H, W, 3 if ctype == 2 else 1)).astype(
        np.uint8)
    path = tmp_path / "a7.png"
    path.write_bytes(_adam7_png(arr, ctype))
    want = cv2.imread(str(path), 0)
    got = read_png_gray(str(path))
    np.testing.assert_array_equal(got, want)
    if ctype == 0:
        np.testing.assert_array_equal(got, arr[..., 0])


# ---------------------------------------------------------------------------
# the style path in bfloat16
# ---------------------------------------------------------------------------

def _bf16_pair():
    """The extraction tests' narrow model (``test_torch_extract.py``) with
    ``compute_dtype="bfloat16"`` on both sides, and the port's float32
    model, on one numpy tree."""
    from handwriting_line_generation_tpu.models.hw_with_style import \
        HWWithStyle as JHWWithStyle
    from handwriting_line_generation_tpu_torch.convert import convert_params
    from handwriting_line_generation_tpu_torch.init import init_params
    from handwriting_line_generation_tpu_torch.models.hw_with_style import \
        HWWithStyle
    jcfg, tcfg = _cfgs("single")
    params = init_params(tcfg, 0)
    rng = np.random.default_rng(10)
    for k in ("hwr", "style_extractor"):
        params[k] = perturb(params[k], rng)
    for name, blk in params["generator"].items():
        if name.startswith("StyledConvBlock_"):
            for k in ("NoiseInjection_0", "NoiseInjection_1"):
                blk[k]["weight"][:] = 0.0
    sd = convert_params(params)
    f32 = HWWithStyle(tcfg)
    f32.load_state_dict(sd)
    jcfg.compute_dtype = tcfg.compute_dtype = "bfloat16"
    bf16 = HWWithStyle(tcfg)
    bf16.load_state_dict(sd)
    return (JHWWithStyle(jcfg), jax.tree_util.tree_map(jnp.asarray, params),
            bf16.eval(), f32.eval())


def _port_style(model, image, labels, lens, frames):
    with torch.no_grad():
        style, pred = model.extract_style(_t(image), 2,
                                          frame_lengths=_t(frames))
        img, _ = model.autoencode(
            _t(image), _t(labels), _t(lens), 2, frame_lengths=_t(frames),
            generator=torch.Generator().manual_seed(0))
    return style, pred, img


@pytest.mark.compile
def test_bfloat16_extraction_and_autoencode_match_jax():
    """bf16 compute, float32 weights and outputs.  bf16 rounds each conv's
    sum, and the two frameworks sum in other orders, so neither bf16 path
    is the other's bits: the port's bf16 style, log-probs (unmasked
    frames) and autoencoded image are each held to within 1.5x the JAX
    package's own bf16 error against the float32 run (the port's float32
    model, which ``test_torch_extract.py`` holds to JAX's within 1e-4;
    measured: the port is 0.1x on the style, 1.1x on the log-probs), and
    to within 3x that error of the JAX bf16 output."""
    jm, jp, model, f32 = _bf16_pair()
    batch = _batch(seed=1)
    image, labels, lens, frames = batch
    x, f = jnp.asarray(image), jnp.asarray(frames)
    ws, wp = jax.jit(lambda p: jm.apply(
        {"params": p}, x, 2, frame_lengths=f, method="extract_style"))(jp)
    wi, _ = jax.jit(lambda p: jm.apply(
        {"params": p}, x, jnp.asarray(labels), jnp.asarray(lens), 2,
        frame_lengths=f, method="autoencode",
        rngs={"noise": jax.random.PRNGKey(0)}))(jp)
    j16 = [np.asarray(a, np.float32) for a in (ws, wp, wi)]
    r32 = [a.numpy() for a in _port_style(f32, *batch)]
    got = _port_style(model, *batch)
    for name, g, w16, w32 in zip(("style", "log-probs", "image"), got, j16,
                                 r32):
        assert g.dtype == torch.float32, name
        keep = w32 > -1e29                      # not a masked frame
        g = g.numpy()[keep]
        own = np.abs(w16[keep] - w32[keep]).max()
        assert np.abs(g - w32[keep]).max() <= 1.5 * own + 1e-6, name
        assert np.abs(g - w16[keep]).max() <= 3.0 * own + 1e-6, name
