"""Teacher labels for imitation learning: structured mask assignment that
makes optimal context pairs analytically known.

The port's numpy-only copy of `rovr_tpu/data/teacher.py`: the same draws
from the same `np.random.Generator`, so both packages label the same clips.

Parity: rovr/video_ds_explicit.py:20-32 (group construction),
:114-129 (choose_frame_masks), :133-164 (generate_solutions),
:167-191 (generate_negative_solutions).

Scheme: 7 mask locations are drawn; 20 frames are partitioned into 6 groups;
each group is assigned 4 of the locations such that two specific other groups
expose every masked region — pairs (p, q) from those groups are "positive"
teacher contexts, and same-group pairs are "negative" (useless) contexts.

Known reference quirk (reproduced faithfully, verified empirically): the
exposure property is imperfect for the SECOND pair-block of groups 0 and 2 —
for i in group 0, pairs from (group3 x group4) both mask location l[5]; for
i in group 2, pairs from (group1 x group5) both mask l[6]. The first 8
positive pairs of every frame (and all 16 for groups 4/5) do expose every
masked region; tests assert exactly that.

All pure functions of an np.random.Generator — no hidden state.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

NUM_FRAMES = 20
NUM_LOCATIONS = 7
POSITIVES_PER_FRAME = 16
NEGATIVES_PER_FRAME = 3


@dataclasses.dataclass(frozen=True)
class TeacherAssignment:
    """One sampled teacher configuration for a clip."""

    locations: np.ndarray      # (7,) mask locations in [0, 20)
    frame_order: np.ndarray    # (20,) permutation: dataset frame shuffle
    groups: List[List[int]]    # 6 groups partitioning the 20 frames
    frame_masks: np.ndarray    # (20, 4) mask locations per frame
    positives: np.ndarray      # (20, 16, 2) teacher context pairs
    negatives: np.ndarray      # (20, 3, 2) useless context pairs


def _make_groups(f: np.ndarray) -> List[List[int]]:
    # video_ds_explicit.py:25-32
    return [
        [f[0], f[1], f[4], f[5]],
        [f[2], f[3], f[6], f[7]],
        [f[8], f[9], f[12], f[13]],
        [f[10], f[11], f[14], f[15]],
        [f[16], f[17]],
        [f[18], f[19]],
    ]


def choose_frame_masks(groups: List[List[int]], l: np.ndarray) -> np.ndarray:
    """(20, 4) mask-location assignment per frame (video_ds_explicit.py:114-129)."""
    per_group = [
        [l[0], l[1], l[3], l[5]],
        [l[0], l[1], l[4], l[6]],
        [l[1], l[2], l[3], l[6]],
        [l[1], l[2], l[4], l[5]],
        [l[0], l[2], l[3], l[5]],
        [l[0], l[2], l[4], l[6]],
    ]
    frame_masks = np.empty((NUM_FRAMES, 4), dtype=np.int64)
    for i in range(NUM_FRAMES):
        for g, members in enumerate(groups):
            if i in members:
                frame_masks[i] = np.asarray(per_group[g])
                break
    return frame_masks


def _pairs(a: List[int], b: List[int]) -> np.ndarray:
    return np.array([[p, q] for p in a for q in b], dtype=np.int64)


def generate_solutions(groups: List[List[int]]) -> np.ndarray:
    """(20, 16, 2) positive context pairs (video_ds_explicit.py:133-164)."""
    g = groups
    solutions = np.empty((NUM_FRAMES, POSITIVES_PER_FRAME, 2), dtype=np.int64)
    for i in range(NUM_FRAMES):
        if i in g[0]:
            solutions[i] = np.concatenate([_pairs(g[2], g[5]), _pairs(g[3], g[4])])
        elif i in g[1]:
            solutions[i] = np.concatenate([_pairs(g[2], g[4]), _pairs(g[3], g[4])])
        elif i in g[2]:
            solutions[i] = np.concatenate([_pairs(g[0], g[5]), _pairs(g[1], g[5])])
        elif i in g[3]:
            solutions[i] = np.concatenate([_pairs(g[0], g[5]), _pairs(g[1], g[4])])
        elif i in g[4]:
            solutions[i] = _pairs(g[1], g[2])
        elif i in g[5]:
            solutions[i] = _pairs(g[0], g[2])
    return solutions


def generate_negative_solutions(groups: List[List[int]]) -> np.ndarray:
    """(20, 3, 2) same-group (useless) pairs (video_ds_explicit.py:167-191)."""
    g = groups
    neg = np.empty((NUM_FRAMES, NEGATIVES_PER_FRAME, 2), dtype=np.int64)
    for i in range(NUM_FRAMES):
        for j in range(4):
            if i in g[j]:
                temp = [x for x in g[j] if x != i]
                neg[i] = np.array(
                    [
                        [temp[0], temp[1]],
                        [temp[0], temp[2]],
                        [temp[1], temp[2]],
                    ]
                )
        if i in g[4]:
            temp = [x for x in g[4] if x != i]
            neg[i] = np.concatenate(
                [_pairs(temp, g[1]), _pairs(temp, g[2])]
            )[:NEGATIVES_PER_FRAME]
        if i in g[5]:
            temp = [x for x in g[5] if x != i]
            neg[i] = np.concatenate(
                [
                    _pairs(temp, g[2]),
                    np.array([[q, p] for p in temp for q in g[2]], dtype=np.int64),
                ]
            )[:NEGATIVES_PER_FRAME]
    return neg


def sample_assignment(rng: np.random.Generator) -> TeacherAssignment:
    """Draw one teacher configuration (video_ds_explicit.py:21-32 new_random)."""
    locations = rng.permutation(NUM_FRAMES)[:NUM_LOCATIONS]
    frame_order = rng.permutation(NUM_FRAMES)
    groups = _make_groups(frame_order)
    return TeacherAssignment(
        locations=locations,
        frame_order=frame_order,
        groups=groups,
        frame_masks=choose_frame_masks(groups, locations),
        positives=generate_solutions(groups),
        negatives=generate_negative_solutions(groups),
    )
