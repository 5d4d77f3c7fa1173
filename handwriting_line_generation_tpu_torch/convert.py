"""flax param trees -> this package's ``state_dict``s.

:func:`convert_params` covers the ``generator``, ``spacer``, ``hwr``,
``style_extractor`` and ``discriminator`` subtrees of ``HWWithStyle``, and
the discriminator's ``spectral`` collection when given (each
``SNConv_<i>/u``, a buffer of the port's ``sn.<i>``); any other key
raises.
:func:`convert_hwr_params` converts a recognizer tree (``CNNOnlyHWR``,
``CRNN`` or ``SmallCRNN``) and
:func:`convert_autoencoder_params` an ``Autoencoder`` tree.  Layout rules:

* Dense ``[in, out]`` -> Linear ``[out, in]``.
* 2-D conv HWIO -> OIHW; 1-D conv ``[k, in, out]`` -> ``[out, in, k]``.
* The generator's initial ``nn.ConvTranspose((4, 3), padding=((3, 3),
  (1, 1)))`` has stride 1 and flax does not flip its kernel, so it is a
  plain correlation of the padded input: OIHW, not flipped, run as
  ``conv2d`` (``StyledConvBlock``).
* ``FusedUpsample`` runs ``lax.conv_transpose`` (stride 2) unflipped, where
  torch's ``conv_transpose2d`` flips: ``[in, out, kh, kw]``, spatially
  flipped.  So do the autoencoder's decoders' ``nn.ConvTranspose`` layers
  (strides 1 and 2), run by ``models.layers.conv_transpose``.
* NoiseInjection ``[1, 1, 1, C]`` -> ``[C]``; GroupNorm ``scale`` -> weight.
* A forward and a reversed ``OptimizedLSTMCell`` -> one ``BiLSTM``: the
  input kernels ``ii/if/ig/io`` (no bias) and the recurrent ``hi/hf/hg/ho``
  (with bias) concatenated in torch's (i, f, g, o) row order.
* The style extractor's vmapped per-class extractors (and ``FillPred``)
  carry a leading class axis: each 1-D conv kernel ``[N, k, in, out]`` ->
  ``[N, out, in, k]``; dense kernels stay ``[N, in, out]``.

bfloat16 leaves (``ml_dtypes`` arrays, or the torch tensors of
``utils/msgpack.py``) convert exactly through float32.

A raw JAX checkpoint (``utils.checkpoint.load_raw_checkpoint``) is routed
by its layout: :func:`convert_checkpoint` takes a GAN ``checkpoint-*`` (the
whole train state: ``params`` and ``spectral``, the optimizer moments left
behind), a ``model_best`` (``{params, spectral}``) or a bare ``<name>-swa``
params tree; :func:`hwr_tree` the recognizer of a standalone HWR state or
of a composite checkpoint, and :func:`encoder_tree` an autoencoder state's
encoder.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch


def _np(a) -> np.ndarray:
    """A leaf as numpy: a ``torch.bfloat16`` leaf of ``utils/msgpack.py``
    widens to float32 (exact)."""
    return a.float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _tensor(a) -> torch.Tensor:
    a = np.array(_np(a))             # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _dense(k):
    return k.T


def _conv(k):
    return k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.transpose(2, 1, 0)


def _flipped_transpose(k):
    return k.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]


def _leaves(tree: Mapping, where: str, out: Dict[str, torch.Tensor],
            prefix: str, rules: Dict[str, tuple]) -> None:
    """``rules``: flax leaf name -> (torch name, layout fn); exact key set."""
    if set(tree) != set(rules):
        raise KeyError(f"{where}: expected keys {sorted(rules)}, got "
                       f"{sorted(tree)}")
    for name, (tname, fn) in rules.items():
        out[prefix + tname] = _tensor(fn(_np(tree[name])))


def _ident(a):
    return a


def _layer(tree, where, out, prefix, kernel_fn: Callable = _conv):
    _leaves(tree, where, out, prefix,
            {"kernel": ("weight", kernel_fn), "bias": ("bias", _ident)})


def _index(name: str, stem: str) -> int:
    if not name.startswith(stem) or not name[len(stem):].isdigit():
        raise KeyError(f"unexpected key {name!r} (want {stem}<n>)")
    return int(name[len(stem):])


def _block(tree: Mapping, where: str, out, p: str) -> None:
    convs = {"ConvTranspose_0": "conv1", "FusedUpsample_0": "conv1"}
    if "Conv_1" in tree:            # nearest upsample + conv, then conv2
        convs.update(Conv_0="conv1", Conv_1="conv2")
    else:
        convs["Conv_0"] = "conv2"
    for name, sub in tree.items():
        w = f"{where}/{name}"
        if name in convs:
            fn = _flipped_transpose if name == "FusedUpsample_0" else _conv
            _layer(sub, w, out, f"{p}{convs[name]}.", fn)
        elif name in ("NoiseInjection_0", "NoiseInjection_1"):
            _leaves(sub, w, out, f"{p}noise{int(name[-1]) + 1}.",
                    {"weight": ("weight", lambda a: a.reshape(-1))})
        elif name in ("AdaIN_0", "AdaIN_1"):
            if set(sub) != {"Dense_0"}:
                raise KeyError(f"{w}: expected Dense_0, got {sorted(sub)}")
            _layer(sub["Dense_0"], f"{w}/Dense_0", out,
                   f"{p}adain{int(name[-1]) + 1}.linear.", _dense)
        else:
            raise KeyError(f"{w}: unknown key")


def _generator(tree: Mapping, out, p: str) -> None:
    for name, sub in tree.items():
        w = f"generator/{name}"
        if name == "StyleMLP_0":
            for dn, d in sub.items():
                _layer(d, f"{w}/{dn}", out,
                       f"{p}style_mlp.layers.{_index(dn, 'Dense_')}.",
                       _dense)
        elif name.startswith("StyledConvBlock_"):
            _block(sub, w, out,
                   f"{p}blocks.{_index(name, 'StyledConvBlock_')}.")
        elif name == "EqualConv_0":
            _layer(sub, w, out, f"{p}to_gray.")
        else:
            raise KeyError(f"{w}: unknown key")


def _spacer(tree: Mapping, out, p: str) -> None:
    n_conv = sum(k.startswith("Conv_") for k in tree)
    for name, sub in tree.items():
        w = f"spacer/{name}"
        if name in ("mean", "std"):
            out[p + name] = _tensor(sub)
        elif name.startswith("Conv_"):
            i = _index(name, "Conv_")
            _layer(sub, w, out,
                   f"{p}out." if i == n_conv - 1 else f"{p}convs.{i}.")
        elif name.startswith("GroupNorm_"):
            _leaves(sub, w, out, f"{p}norms.{_index(name, 'GroupNorm_')}.",
                    {"scale": ("weight", _ident), "bias": ("bias", _ident)})
        else:
            raise KeyError(f"{w}: unknown key")


def _bank_conv(k):
    return k.transpose(0, 3, 2, 1)


def _bank(tree: Mapping, where: str, out, p: str, names: Dict[str, str]
          ) -> None:
    """A vmapped per-class module: ``names`` maps its flax children to the
    port's bank layers."""
    if set(tree) != set(names):
        raise KeyError(f"{where}: expected keys {sorted(names)}, got "
                       f"{sorted(tree)}")
    for name, tname in names.items():
        w, sub = f"{where}/{name}", tree[name]
        if name.startswith("GroupNorm_"):
            _gn(sub, w, out, f"{p}{tname}.")
        else:
            _layer(sub, w, out, f"{p}{tname}.",
                   _bank_conv if name.startswith("Conv_") else _ident)


_EXTRACTOR = {"Conv_0": "conv0", "GroupNorm_0": "norm0", "Conv_1": "conv1",
              "Conv_2": "conv2", "GroupNorm_1": "norm1", "Dense_0": "dense0",
              "Dense_1": "dense1"}


def _style_extractor(tree: Mapping, out, p: str) -> None:
    for name, sub in tree.items():
        w = f"style_extractor/{name}"
        if name == "StyleTrunk_0":
            for bn, blk in sub.items():
                bp = f"{p}trunk.blocks.{_index(bn, 'ConvBlock_')}."
                for ln, leaf in blk.items():
                    if ln == "Conv_0":
                        _layer(leaf, f"{w}/{bn}/{ln}", out, bp + "conv.")
                    elif ln == "GroupNorm_0":
                        _gn(leaf, f"{w}/{bn}/{ln}", out, bp + "norm.")
                    else:
                        raise KeyError(f"{w}/{bn}/{ln}: unknown key")
        elif name == "VmapCharExtractor_0":
            _bank(sub, w, out, f"{p}bank.", _EXTRACTOR)
        elif name == "VmapFillPred_0":
            _bank(sub, w, out, f"{p}fill.",
                  {"Dense_0": "dense0", "Dense_1": "dense1"})
        elif name.startswith("Conv_"):
            _layer(sub, w, out, f"{p}global_convs.{_index(name, 'Conv_')}.")
        elif name == "GroupNorm_0":
            _gn(sub, w, out, f"{p}global_norm.")
        elif name in ("Dense_0", "Dense_1"):
            _layer(sub, w, out, p + ("dense0." if name == "Dense_0"
                                     else "head."), _dense)
        else:
            raise KeyError(f"{w}: unknown key")


def _discriminator(tree: Mapping, spectral: Optional[Mapping], out,
                   p: str) -> None:
    """``Conv_<i>`` -> ``convs.<i>``, ``GroupNorm_<i>`` -> ``norms.<i>``,
    ``SNConv_<i>`` -> ``sn.<i>`` (with ``u`` from ``spectral``), and the
    ``global_fc``/``global_out``/``cond_proj`` dense layers."""
    for name, sub in tree.items():
        w = f"discriminator/{name}"
        if name.startswith("Conv_"):
            _layer(sub, w, out, f"{p}convs.{_index(name, 'Conv_')}.")
        elif name.startswith("GroupNorm_"):
            _gn(sub, w, out, f"{p}norms.{_index(name, 'GroupNorm_')}.")
        elif name.startswith("SNConv_"):
            i = _index(name, "SNConv_")
            _layer(sub, w, out, f"{p}sn.{i}.")
            if spectral is None:
                continue
            if name not in spectral:
                raise KeyError(f"{w}: no spectral/u for it")
            _leaves(spectral[name], f"spectral/{w}", out, f"{p}sn.{i}.",
                    {"u": ("u", _ident)})
        elif name in ("global_fc", "global_out"):
            _layer(sub, w, out, f"{p}{name}.", _dense)
        elif name == "cond_proj":
            _leaves(sub, w, out, f"{p}{name}.", {"kernel": ("weight", _dense)})
        else:
            raise KeyError(f"{w}: unknown key")
    extra = set(spectral or ()) - set(tree)
    if extra:
        raise KeyError(f"spectral/discriminator: unknown keys {sorted(extra)}")


def convert_params(params: Mapping, spectral: Optional[Mapping] = None
                   ) -> Dict[str, torch.Tensor]:
    """flax ``params`` (nested dict of arrays) -> ``HWWithStyle`` state_dict
    for its ``generator``, ``spacer``, ``hwr``, ``style_extractor`` and
    ``discriminator``; ``spectral`` is the flax ``spectral`` collection,
    whose ``u``'s a discriminator's spectral-norm convs load (without it
    their ``u`` entries are left out)."""
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name == "generator":
            _generator(sub, out, "generator.")
        elif name == "spacer":
            _spacer(sub, out, "spacer.")
        elif name == "hwr":
            _hwr(sub, out, "hwr.")
        elif name == "style_extractor":
            _style_extractor(sub, out, "style_extractor.")
        elif name == "discriminator":
            _discriminator(sub, (spectral or {}).get("discriminator"), out,
                           "discriminator.")
        else:
            raise KeyError(f"unknown subtree {name!r}")
    return out


def _gn(tree, where, out, prefix):
    _leaves(tree, where, out, prefix,
            {"scale": ("weight", _ident), "bias": ("bias", _ident)})


def _convs_and_norms(tree: Mapping, where: str, out, p: str,
                     last_conv: str = "") -> None:
    """``Conv_<i>`` -> ``convs.<i>`` (the ``last_conv`` one -> ``out``) and
    ``GroupNorm_<i>`` -> ``norms.<i>``."""
    for name, sub in tree.items():
        w = f"{where}/{name}"
        if name == last_conv:
            _layer(sub, w, out, f"{p}out.")
        elif name.startswith("Conv_"):
            _layer(sub, w, out, f"{p}convs.{_index(name, 'Conv_')}.")
        elif name.startswith("GroupNorm_"):
            _gn(sub, w, out, f"{p}norms.{_index(name, 'GroupNorm_')}.")
        else:
            raise KeyError(f"{w}: unknown key")


def convert_hwr_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax recognizer params (``CNNOnlyHWR``, ``CRNN`` or ``SmallCRNN``;
    with or without the outer ``"params"`` key) -> the state_dict of the
    ``models.hwr`` module of that kind."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    _hwr(params, out, "")
    return out


_AE_LAYERS = {"Conv_": ("convs", _conv), "ConvTranspose_":
              ("convts", _flipped_transpose)}


def convert_autoencoder_params(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``Autoencoder`` params (with or without the outer ``"params"``
    key) -> ``models.autoencoder.Autoencoder`` state_dict.  Each of the
    ``encoder``, ``decoder`` and ``hwr`` subtrees maps ``Conv_<i>`` (2-D or
    dilated 1-D) -> ``convs.<i>``, ``ConvTranspose_<i>`` -> ``convts.<i>``
    (flipped, ``[in, out, kh, kw]``) and ``GroupNorm_<i>`` -> ``norms.<i>``;
    any other key raises."""
    if set(params) == {"params"}:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for name, sub in params.items():
        if name not in ("encoder", "decoder", "hwr"):
            raise KeyError(f"unknown subtree {name!r}")
        for leaf, tree in sub.items():
            w = f"{name}/{leaf}"
            if leaf.startswith("GroupNorm_"):
                _gn(tree, w, out,
                    f"{name}.norms.{_index(leaf, 'GroupNorm_')}.")
                continue
            stem = leaf.rsplit("_", 1)[0] + "_"
            if stem not in _AE_LAYERS:
                raise KeyError(f"{w}: unknown key")
            tname, fn = _AE_LAYERS[stem]
            _layer(tree, w, out, f"{name}.{tname}.{_index(leaf, stem)}.", fn)
    return out


_GATES = ("i", "f", "g", "o")            # torch's row order of the gates


def _lstm_pair(fwd: Mapping, bwd: Mapping, where: str, out,
               p: str) -> None:
    """Two flax ``OptimizedLSTMCell``s (the forward and the reversed RNN)
    -> a ``models.hwr.BiLSTM``: ``weight_ih[d]`` the ``ii/if/ig/io``
    kernels ``[in, H]`` concatenated and transposed to ``[4H, in]``,
    ``weight_hh[d]`` and ``bias_hh[d]`` those of ``hi/hf/hg/ho``."""
    want = {f"{a}{g}" for a in "ih" for g in _GATES}
    ih, hh, bh = [], [], []
    for d, cell in enumerate((fwd, bwd)):
        w = f"{where}[{d}]"
        if set(cell) != want:
            raise KeyError(f"{w}: expected keys {sorted(want)}, got "
                           f"{sorted(cell)}")
        for g in _GATES:
            if set(cell["i" + g]) != {"kernel"} or \
                    set(cell["h" + g]) != {"kernel", "bias"}:
                raise KeyError(f"{w}: i{g} takes a kernel, h{g} a kernel "
                               f"and a bias")
        ih.append(np.concatenate([_np(cell["i" + g]["kernel"])
                                  for g in _GATES], axis=1).T)
        hh.append(np.concatenate([_np(cell["h" + g]["kernel"])
                                  for g in _GATES], axis=1).T)
        bh.append(np.concatenate([_np(cell["h" + g]["bias"])
                                  for g in _GATES]))
    for name, parts in (("weight_ih", ih), ("weight_hh", hh),
                        ("bias_hh", bh)):
        out[p + name] = _tensor(np.stack(parts))


def _crnn_head(params: Mapping, where: str, out, p: str,
               dense_names: Dict[int, str]) -> Dict:
    """The LSTM pairs (``OptimizedLSTMCell_<2l>``, ``_<2l+1>`` ->
    ``lstms.<l>``, or ``lstm`` when there is one pair) and the dense
    layers (``Dense_<i>`` -> ``dense_names[i]``); returns the other
    entries."""
    cells = sorted(_index(k, "OptimizedLSTMCell_") for k in params
                   if k.startswith("OptimizedLSTMCell_"))
    if cells != list(range(len(cells))) or len(cells) % 2:
        raise KeyError(f"{where}: LSTM cells {cells}, want pairs from 0")
    for l in range(len(cells) // 2):
        _lstm_pair(params[f"OptimizedLSTMCell_{2 * l}"],
                   params[f"OptimizedLSTMCell_{2 * l + 1}"],
                   f"{where}/OptimizedLSTMCell_{2 * l}+1", out,
                   p + ("lstm." if len(cells) == 2 else f"lstms.{l}."))
    rest = {}
    for name, sub in params.items():
        if name.startswith("Dense_"):
            i = _index(name, "Dense_")
            if i not in dense_names:
                raise KeyError(f"{where}/{name}: unknown key")
            _layer(sub, f"{where}/{name}", out, p + dense_names[i], _dense)
        elif not name.startswith("OptimizedLSTMCell_"):
            rest[name] = sub
    return rest


def _hwr(params: Mapping, out, p: str) -> None:
    """A ``CNNOnlyHWR``, ``CRNN`` (LSTM cells beside ``_ConvTrunk_0``) or
    ``SmallCRNN`` (LSTM cells, no ``_ConvTrunk_0``) tree."""
    lstm = "OptimizedLSTMCell_0" in params
    if lstm and "_ConvTrunk_0" not in params:          # SmallCRNN
        rest = _crnn_head(params, "hwr", out, p, {0: "out."})
        _convs_and_norms(rest, "hwr", out, p)
        return
    if "_ConvTrunk_0" not in params:
        raise KeyError("hwr: missing _ConvTrunk_0")
    _convs_and_norms(params["_ConvTrunk_0"], "hwr/_ConvTrunk_0", out,
                     p + "trunk.")
    head = {k: v for k, v in params.items() if k != "_ConvTrunk_0"}
    if lstm:                                           # CRNN
        rest = _crnn_head(head, "hwr", out, p,
                          {0: "denses.0.", 1: "denses.1.", 2: "out."})
        if rest:
            raise KeyError(f"hwr: unknown keys {sorted(rest)}")
        return
    n_conv = sum(k.startswith("Conv_") for k in params)
    _convs_and_norms(head, "hwr", out, p, last_conv=f"Conv_{n_conv - 1}")


def convert_checkpoint(raw: Mapping) -> Dict[str, torch.Tensor]:
    """The ``HWWithStyle`` state_dict of a raw JAX GAN checkpoint: a
    ``checkpoint-*`` (the whole state) or a ``model_best`` gives its
    ``params`` and ``spectral``; a bare params tree (``<name>-swa``) gives
    the parameters alone.  Optimizer moments, saved gradients and the style
    bank are not carried over."""
    if "params" in raw:
        return convert_params(raw["params"], raw.get("spectral") or None)
    return convert_params(raw)


def hwr_tree(raw: Mapping) -> Mapping:
    """The recognizer tree of a raw JAX checkpoint, as the JAX GAN's
    ``pretrained_hwr`` finds it: ``raw["params"]``, then its ``params``
    (a standalone HWR state or ``model_best``), then its ``hwr`` (a
    composite checkpoint)."""
    tree = raw["params"]
    if "params" in tree:
        tree = tree["params"]
    if "hwr" in tree:
        tree = tree["hwr"]
    return tree


def encoder_tree(raw: Mapping) -> Mapping:
    """The perceptual encoder tree of a raw JAX autoencoder state (or its
    ``model_best``): ``raw["params"]["params"]["encoder"]``."""
    return raw["params"]["params"]["encoder"]
