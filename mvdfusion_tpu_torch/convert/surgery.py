"""Checkpoint key surgery (the port's copy of mvdfusion_tpu/convert/surgery.py).

The reference's state-dict rewriting (utils/load_model.py:28-110): prefix
replacement (`replace_key`), explicit renames (`param_mapper`,
mvdfusion/unet.py:70-86), key dropping (`remove_keys` for shape-changed
convs, `ignore_keys` for new layers), and the missing/unexpected-key
report. Operates on {str: tensor} dicts.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional, Sequence, Tuple

# the 14 keys whose positions shift when the ViewAligned layers are inserted
# into the middle/output blocks (mvdfusion/unet.py:70-86)
ZERO123_PARAM_MAPPER: Dict[str, str] = {}
for _k in ("conv.weight", "conv.bias"):
    ZERO123_PARAM_MAPPER[f"output_blocks.5.2.{_k}"] = f"output_blocks.5.3.{_k}"
    ZERO123_PARAM_MAPPER[f"output_blocks.8.2.{_k}"] = f"output_blocks.8.3.{_k}"
for _k in (
    "in_layers.0.weight",
    "in_layers.0.bias",
    "in_layers.2.weight",
    "in_layers.2.bias",
    "emb_layers.1.weight",
    "emb_layers.1.bias",
    "out_layers.0.weight",
    "out_layers.0.bias",
    "out_layers.3.weight",
    "out_layers.3.bias",
):
    ZERO123_PARAM_MAPPER[f"middle_block.2.{_k}"] = f"middle_block.3.{_k}"

# in/out convs whose shapes changed 8->10 / 4->5 channels
# (viewfusion_zero_depth_rgb.py:69)
ZERO123_REMOVE_KEYS = ("input_blocks.0.0.weight", "out.2.weight", "out.2.bias")


def apply_surgery(
    state: Mapping[str, object],
    replace_key: Optional[Tuple[str, str]] = None,
    param_mapper: Optional[Mapping[str, str]] = None,
    remove_keys: Sequence[str] = (),
    ignore_keys: Sequence[str] = (),
    keep_only_prefix: Optional[str] = None,
) -> Dict[str, object]:
    """Rewrite a flat state dict. Order matches load_model.py:44-67:
    prefix replace -> param_mapper rename -> remove -> ignore-prefix drop."""
    out: Dict[str, object] = {}
    for k, v in state.items():
        if keep_only_prefix is not None:
            if not k.startswith(keep_only_prefix):
                continue
        if replace_key is not None:
            old, new = replace_key
            if k.startswith(old):
                k = new + k[len(old):]
        if param_mapper and k in param_mapper:
            k = param_mapper[k]
        if k in remove_keys:
            continue
        if any(k.startswith(ig) or ig in k for ig in ignore_keys):
            continue
        out[k] = v
    return out


def report_load(target_keys: Iterable[str], source_keys: Iterable[str], verbose: bool = True):
    """Missing/unexpected-key report (load_model.py:69-92)."""
    tset, sset = set(target_keys), set(source_keys)
    missing = sorted(tset - sset)
    unexpected = sorted(sset - tset)
    if verbose:
        if missing:
            print(f"[convert] {len(missing)} missing keys (will keep init), e.g. {missing[:5]}")
        if unexpected:
            print(f"[convert] {len(unexpected)} unexpected keys dropped, e.g. {unexpected[:5]}")
    return missing, unexpected
