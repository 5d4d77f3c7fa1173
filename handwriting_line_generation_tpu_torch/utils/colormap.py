"""Colour tables as numpy constants, and :func:`apply_colormap`.

* :data:`VIRIDIS` — OpenCV's ``COLORMAP_VIRIDIS`` (256 entries), so that
  ``play_styles --heatmap`` writes the pixels that ``cv2.imwrite`` of
  ``cv2.applyColorMap(d, cv2.COLORMAP_VIRIDIS)`` writes;
* :data:`TAB10` — matplotlib's ``tab10``, its default line colour cycle
  ``C0`` .. ``C9``;
* :data:`TAB20` — matplotlib's ``tab20``.

Each is ``uint8`` ``[n, 3]`` in RGB order.
"""

from __future__ import annotations

import numpy as np


def _table(hexes: str) -> np.ndarray:
    raw = bytes.fromhex("".join(hexes.split()))
    return np.frombuffer(raw, np.uint8).reshape(-1, 3).copy()


VIRIDIS = _table(
    "44015444025645045745055946075a46085c460a5d460b5e470d60470e61471063471164"
    "47136548146748166848176948186a481a6c481b6d481c6e481d6f481f70482071482173"
    "482374482475482576482677482878482979472a7a472c7a472d7b472e7c472f7d46307e"
    "46327e46337f463480453581453781453882443983443a83443b84433d84433e85423f85"
    "4240864241864142874144874045884046883f47883f48893e49893e4a893e4c8a3d4d8a"
    "3d4e8a3c4f8a3c508b3b518b3b528b3a538b3a548c39558c39568c38588c38598c375a8c"
    "375b8d365c8d365d8d355e8d355f8d34608d34618d33628d33638d32648e32658e31668e"
    "31678e31688e30698e306a8e2f6b8e2f6c8e2e6d8e2e6e8e2e6f8e2d708e2d718e2c718e"
    "2c728e2c738e2b748e2b758e2a768e2a778e2a788e29798e297a8e297b8e287c8e287d8e"
    "277e8e277f8e27808e26818e26828e26828e25838e25848e25858e24868e24878e23888e"
    "23898e238a8d228b8d228c8d228d8d218e8d218f8d21908d21918c20928c20928c20938c"
    "1f948c1f958b1f968b1f978b1f988b1f998a1f9a8a1e9b8a1e9c891e9d891f9e891f9f88"
    "1fa0881fa1881fa1871fa28720a38620a48621a58521a68522a78522a88423a98324aa83"
    "25ab8225ac8226ad8127ad8128ae8029af7f2ab07f2cb17e2db27d2eb37c2fb47c31b57b"
    "32b67a34b67935b77937b87838b9773aba763bbb753dbc743fbc7340bd7242be7144bf70"
    "46c06f48c16e4ac16d4cc26c4ec36b50c46a52c56954c56856c66758c7655ac8645cc863"
    "5ec96260ca6063cb5f65cb5e67cc5c69cd5b6ccd5a6ece5870cf5773d05675d05477d153"
    "7ad1517cd2507fd34e81d34d84d44b86d54989d5488bd6468ed64590d74393d74195d840"
    "98d83e9bd93c9dd93ba0da39a2da37a5db36a8db34aadc32addc30b0dd2fb2dd2db5de2b"
    "b8de29bade28bddf26c0df25c2df23c5e021c8e020cae11fcde11dd0e11cd2e21bd5e21a"
    "d8e219dae319dde318dfe318e2e418e5e419e7e419eae51aece51befe51cf1e51df4e61e"
    "f6e620f8e621fbe723fde725")

TAB10 = _table("1f77b4 ff7f0e 2ca02c d62728 9467bd 8c564b e377c2 7f7f7f "
               "bcbd22 17becf")

TAB20 = _table("1f77b4 aec7e8 ff7f0e ffbb78 2ca02c 98df8a d62728 ff9896 "
               "9467bd c5b0d5 8c564b c49c94 e377c2 f7b6d2 7f7f7f c7c7c7 "
               "bcbd22 dbdb8d 17becf 9edae5")

for _t in (VIRIDIS, TAB10, TAB20):
    _t.flags.writeable = False


def apply_colormap(u8: np.ndarray, table: np.ndarray = VIRIDIS
                   ) -> np.ndarray:
    """``[H, W]`` uint8 -> ``[H, W, 3]`` uint8 RGB: each value's row of
    ``table`` (256 entries)."""
    u8 = np.asarray(u8)
    if u8.dtype != np.uint8 or u8.ndim != 2:
        raise ValueError(f"expected [H, W] uint8, got {u8.dtype} "
                         f"{u8.shape}")
    return table[u8]
