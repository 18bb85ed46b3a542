"""The work of HMR 2.0 as stage 2 (``benchmark/reference/hmr2.py``): a
person's floating-point operations, counted on the plain reference with
``work.count_flops`` on meta tensors, and its attention's operations and
bytes, from which ``attention_roofline.predict`` takes the least time.

Attention, per person: the trunk's ``depth`` layers of q kᵀ and p v over
its N tokens (N x N x head size products each, every head), and the
decoder's cross-attentions of its one query over the N tokens; the
decoder's self-attention over its one token is its value projection
(softmax of one score is 1) and counts as zero. Bytes: q, k and v read
and the output written once a layer, fp32.
"""

from __future__ import annotations

import functools
import json

import torch

from benchmark import work

# The card's highest rate for fp32-accurate products: TF32 on the tensor
# cores (H100 SXM, dense) in three passes (3xTF32), as cutlass's fp32
# attention kernels may compute.
PEAK_3XTF32_FLOPS = 494.7e12 / 3
FP32 = 4


def _tokens(hmr: dict) -> int:
    vit = hmr['vit']
    res, p = hmr['img_res'], vit['patch_size']
    return ((res + 4 - p) // p + 1) * ((res - 2 * (res // 8) + 4 - p) // p
                                       + 1)


def attention_work(hmr: dict) -> tuple[float, float]:
    """One person's attention operations and bytes (``hmr``: a
    configuration's ``hmr`` entry)."""
    vit, dec = hmr['vit'], hmr['decoder']
    n, width = _tokens(hmr), vit['embed_dim']
    inner = dec['heads'] * dec['dim_head']
    flops = (vit['depth'] * 2 * 2 * n * n * width
             + dec['depth'] * 2 * 2 * n * inner)
    nbytes = FP32 * (vit['depth'] * 4 * n * width
                     + dec['depth'] * (2 * inner + 2 * n * inner))
    return float(flops), float(nbytes)


def attention_bound_s(persons: int, hmr: dict) -> float:
    """The least time of ``persons`` persons' attention on the card."""
    flops, nbytes = attention_work(hmr)
    return work.bound_s(persons * flops, persons * nbytes,
                        peak=PEAK_3XTF32_FLOPS)


def person_flops(hmr: dict, vertices: int) -> float:
    """One person through HMR 2.0 (a ``img_res``² crop) and SMPL's
    blendshapes, joints and skinning."""
    return _person_flops(json.dumps(hmr, sort_keys=True), vertices)


@functools.cache
def _person_flops(hmr_json: str, vertices: int) -> float:
    from benchmark.reference import hmr2
    from benchmark.reference.smpl import joints49, lbs

    hmr = json.loads(hmr_json)
    with torch.device('meta'):
        model = hmr2.HMR2.from_config(hmr)
        assets = {'v_template': torch.empty(vertices, 3),
                  'shapedirs': torch.empty(10, vertices * 3),
                  'posedirs': torch.empty(207, vertices * 3),
                  'j_regressor': torch.empty(24, vertices),
                  'j_regressor_extra': torch.empty(9, vertices),
                  'lbs_weights': torch.empty(vertices, 24)}

        def step(x):
            out = model(x)
            verts, j24 = lbs(assets, out['pred_shape'], out['pred_pose'])
            return joints49(assets, verts, j24)

        res = hmr['img_res']
        return work.count_flops(step, torch.empty(1, 3, res, res))
