"""SPEC config yamls: the subset of ``spec_tpu/utils/config.py`` that
inference reads.

:class:`CfgNode` is a copy of the reference's attribute-tree dict. Of
the defaults, only the keys :func:`hmr_hparams_from_cfg` reads are kept:
a yaml merges over them permissively, as in the reference, so the
training keys it carries are kept but unused. PyYAML is imported where a
file is read (the machine with the card has none).
"""

from __future__ import annotations

from typing import List


class CfgNode(dict):
    """Nested attribute dict (yacs-lite)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    @classmethod
    def from_dict(cls, d: dict) -> 'CfgNode':
        node = cls()
        for k, v in d.items():
            node[k] = cls.from_dict(v) if isinstance(v, dict) else v
        return node

    def clone(self) -> 'CfgNode':
        return CfgNode.from_dict(self.to_dict())

    def to_dict(self) -> dict:
        return {k: v.to_dict() if isinstance(v, CfgNode) else v
                for k, v in self.items()}

    def merge_from_dict(self, other: dict):
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            else:
                self[k] = CfgNode.from_dict(v) if isinstance(v, dict) else v

    def merge_from_file(self, path: str):
        import yaml

        with open(path) as f:
            self.merge_from_dict(yaml.safe_load(f) or {})

    def merge_from_list(self, opts: List[str]):
        """``['HMR.BACKBONE', 'resnet18', ...]`` override pairs; unknown
        keys are rejected, as yacs does."""
        if len(opts) % 2:
            raise ValueError(f'odd --opts list: {opts}')
        for key, val in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split('.')
            for p in parts[:-1]:
                node = node[p]
            if parts[-1] not in node:
                raise KeyError(
                    f'--opts key {key!r} does not exist in the config '
                    f'(yacs rejects unknown keys; check for typos)')
            node[parts[-1]] = _coerce(val, node[parts[-1]])

    def dump(self, path: str):
        import yaml

        with open(path, 'w') as f:
            yaml.safe_dump(self.to_dict(), f, default_flow_style=False)


def _coerce(val: str, old):
    import yaml

    if isinstance(old, bool):
        return val in ('True', 'true', '1')
    if isinstance(old, int):
        try:
            return int(val)
        except ValueError:
            return float(val)
    if isinstance(old, float):
        return float(val)
    try:
        return yaml.safe_load(val)
    except yaml.YAMLError:
        return val


def spec_default_config() -> CfgNode:
    """The reference's SPEC defaults, reduced to what inference reads."""
    return CfgNode.from_dict({
        'HMR': {'BACKBONE': 'resnet50', 'USE_CAM_FEATS': False},
    })


def hmr_hparams_from_cfg(cfg_file: str) -> tuple:
    """(backbone, use_cam_feats) from a SPEC config yaml: the model
    hyperparameters shipped next to a checkpoint."""
    cfg = spec_default_config()
    cfg.merge_from_file(cfg_file)
    return cfg.HMR.BACKBONE, bool(cfg.HMR.USE_CAM_FEATS)
