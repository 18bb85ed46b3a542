"""A cell at a size the CPU runs in seconds: ResNet-18 in both stages,
64-px short side and crops, 96 x 128 frames, two frames a call."""

import copy
import json

from benchmark import run
from benchmark.run import HERE


def config() -> dict:
    cfg = json.loads((HERE / 'configs' / 'spec-resnet50.json').read_text())
    cfg['camcalib'].update(backbone='resnet18', min_size=64)
    cfg['hmr'].update(backbone='resnet18', img_res=64)
    cfg['batch_size'] = 4
    return cfg


def mix(name='crowd_video') -> dict:
    m = json.loads((HERE / 'traffic' / f'{name}.json').read_text())
    if name == 'train_b64':
        m.update(batch=4, img_res=64, pool=4, box_scale=[1.0, 2.0])
        return m
    m.update(frames_per_call=2, box_height_px=[40, 90], jitter_px=2,
             scenes=2, camcalib_every=2)
    if name == 'crowd_video':
        m.update(sizes=[[96, 128]], persons=[1, 3])
    else:
        m.update(sizes=[[96, 128], [128, 96]], persons=[1, 2],
                 camcalib_every=1)
    return m


def cell(name='crowd_video', limits=None) -> run.Cell:
    bench = json.loads((HERE.parent / 'BENCHMARK.json').read_text())
    return run.Cell('tiny', config(), mix(name),
                    copy.deepcopy(bench['end_to_end']),
                    copy.deepcopy(bench['per_layer']),
                    limits or {})
