"""Procedural face dataset: structured, *learnable* synthetic data
(counterpart of hifidiff_tpu/data/procedural.py; numpy, so its samples are
bit-equal to the JAX package's for the same arguments).

`SyntheticFaceDataset` (cli/common.py) draws lr/gt independently — fine
for smoke-testing shapes, useless for demonstrating that training works
(there is nothing to learn). This module renders a deterministic family
of parametric "faces" with disentangled identity / pose factors so every
reference training stage has real signal:

  * stage 1 (CR, `train_cr.py:56-94`): lr is a degraded *posed* render,
    gt the frontal render of the same identity -> restoration +
    frontalization is a smooth learnable map;
  * stage 2 (IDC, `pretrain_idc.py:13-34`): triplets (lr of id i,
    frontal of id i, frontal of id j != i) with identity-dependent
    colors/geometry -> metric learning has a signal;
  * stage 3 (denoiser, `pretrain_denoiser.py:123-227`): "image" = HQ
    frontal renders -> a low-entropy image family a tiny latent DDPM can
    actually model;
  * stage 4 (refiner): lr/gt pairs as in stage 1.

Faces are composed of soft-edged ellipses (background, head, two eyes,
nose, mouth) whose colors and geometry are identity-specific; yaw "pose"
shifts the features laterally and shrinks the far-side eye, mimicking
the non-frontal -> frontal task of the reference (Multi-PIE camera
angles, `dataset_multipie.py:17-18`). The LR protocol matches the
reference exactly: bicubic down x4, bicubic up, 8-bit quantization
(`dataset_kface.py:88-91`, `dataset_multipie.py:148-166`).

Everything is deterministic in (seed, index) - safe for multi-process
sharded loading and bitwise-reproducible resume tests.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from hifidiff_tpu_torch.data.core import Dataset, Sample
from hifidiff_tpu_torch.data.resize import resize_cv2

# what `degrade_lr` resizes with, as `chip_smoke.py` reports it
LR_RESIZE = ("resize_cv2 cubic (cv2 INTER_CUBIC semantics, the host library's "
             "image.cc)")


def _identity_params(seed: int, ident: int,
                     spread: float = 1.0) -> Dict[str, np.ndarray]:
    """Identity-specific render parameters. `spread` scales how far each
    identity sits from the family MEAN: 1.0 is the legacy wide family
    (bit-identical to the original renders: the raw rng stream is read in
    the same order and returned untouched); small values pack identities
    tightly so they cannot be told apart by raw color statistics — the
    hard tier for IDC metric learning (at spread 1.0 the
    triplet margin is satisfied at random init and stage 2 learns
    nothing)."""
    rng = np.random.default_rng((seed, 7919, ident))

    def u(lo, hi, n=None):
        raw = rng.uniform(lo, hi, n)
        if spread == 1.0:
            return raw
        mid = 0.5 * (lo + hi)
        return mid + spread * (raw - mid)

    return {
        "bg": u(0.05, 0.35, 3),
        "skin": u(0.45, 0.9, 3),
        "eye": u(0.0, 0.45, 3),
        "mouth": np.array([u(0.5, 0.9), u(0.05, 0.3),
                           u(0.05, 0.3)]),
        "nose": u(0.3, 0.7, 3),
        "eye_dx": u(0.16, 0.26),
        "eye_y": u(0.36, 0.46),
        "eye_r": u(0.05, 0.08),
        "nose_len": u(0.1, 0.16),
        "mouth_y": u(0.66, 0.76),
        "mouth_w": u(0.12, 0.2),
        "mouth_h": u(0.035, 0.06),
        "face_rx": u(0.3, 0.38),
        "face_ry": u(0.38, 0.46),
    }


def _ellipse(grid_y, grid_x, cy, cx, ry, rx, sharp):
    d = ((grid_x - cx) / rx) ** 2 + ((grid_y - cy) / ry) ** 2
    return 1.0 / (1.0 + np.exp(np.clip((d - 1.0) * sharp, -30.0, 30.0)))


def _identity_marks(seed: int, ident: int,
                    n_spots: int = 14) -> Dict[str, np.ndarray]:
    """Per-identity facial-mark ("freckle") pattern: spot positions in
    face-relative polar coordinates, per-spot darkening gains and radii.
    Drawn from an INDEPENDENT rng stream so enabling `detail` never
    perturbs the legacy identity/pose/negative draws. The marks are the
    fine, identity-deterministic detail the `detail` knob paints: at the
    reference geometry (128 px) they are ~2-4 px spots that the x4
    bicubic degradation erases, so restoring them requires the model to
    learn the identity -> mark-pattern map — the analog of the real
    facial detail HifiDiff hallucinates."""
    rng = np.random.default_rng((seed, 15013, ident))
    return {
        "ang": rng.uniform(0.0, 2.0 * np.pi, n_spots),
        # sqrt for ~uniform areal density; keep off the exact center
        "rad": np.sqrt(rng.uniform(0.06, 0.85, n_spots)),
        "gain": rng.uniform(0.3, 0.55, n_spots),
        "size": rng.uniform(0.016, 0.03, n_spots),
    }


def _clutter_shapes(seed: int, index: int, count: int):
    """Per-SAMPLE background clutter: `count` colored ellipses behind the
    face (positions/colors/radii from an independent per-index stream).
    The same shapes appear in the posed input render and the frontal gt
    (one scene, head turns), so the background is inferable from lr —
    but its sharp edges are destroyed by the x4 degradation and must be
    re-synthesized, giving the diffusion posterior real multi-scale
    structure at the reference geometry."""
    rng = np.random.default_rng((seed, 104731, index))
    return {
        "cy": rng.uniform(0.0, 1.0, count),
        "cx": rng.uniform(0.0, 1.0, count),
        "ry": rng.uniform(0.05, 0.16, count),
        "rx": rng.uniform(0.05, 0.16, count),
        "color": rng.uniform(0.0, 1.0, (count, 3)),
    }


def render_face(idp: Dict[str, np.ndarray], pose: float,
                size: int, detail: float = 0.0,
                marks: Dict[str, np.ndarray] = None,
                clutter=None) -> np.ndarray:
    """Render one face (HWC float32 in [0,1]). pose=0 is frontal; |pose|<=1
    shifts features laterally (yaw) and shrinks the far-side eye.
    `detail` > 0 paints the per-identity `marks` spot pattern on the skin
    (amplitude = detail); `clutter` paints background shapes behind the
    face. Defaults reproduce the legacy render bit-exactly."""
    ys, xs = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size),
                         indexing="ij")
    sharp = 8.0
    shift = 0.12 * pose
    img = np.broadcast_to(idp["bg"], (size, size, 3)).astype(np.float32).copy()

    def paint(alpha, color):
        nonlocal img
        img = img * (1.0 - alpha[..., None]) + alpha[..., None] * color

    if clutter is not None:
        for i in range(len(clutter["cy"])):
            paint(_ellipse(ys, xs, clutter["cy"][i], clutter["cx"][i],
                           clutter["ry"][i], clutter["rx"][i], sharp * 4),
                  clutter["color"][i])
    squeeze = 1.0 - 0.25 * abs(pose)
    paint(_ellipse(ys, xs, 0.52, 0.5 + shift,
                   idp["face_ry"], idp["face_rx"] * squeeze,
                   sharp), idp["skin"])
    if detail > 0.0 and marks is not None:
        # spots ride the face: polar offsets scale with the (pose-
        # squeezed) face radii and shift with yaw
        spot_color = idp["skin"] * (1.0 - detail * marks["gain"][:, None])
        for i in range(len(marks["ang"])):
            cx = (0.5 + shift + marks["rad"][i] * np.cos(marks["ang"][i])
                  * idp["face_rx"] * 0.82 * squeeze)
            cy = (0.52 + marks["rad"][i] * np.sin(marks["ang"][i])
                  * idp["face_ry"] * 0.82)
            r = marks["size"][i]
            paint(_ellipse(ys, xs, cy, cx, r, r * squeeze, sharp * 3),
                  spot_color[i])
    # eyes: the eye on the side the face turns away from shrinks
    for side in (-1.0, 1.0):
        r = idp["eye_r"] * (1.0 - 0.35 * max(0.0, side * pose))
        paint(_ellipse(ys, xs, idp["eye_y"],
                       0.5 + side * idp["eye_dx"] * (1 - 0.3 * abs(pose))
                       + shift, r, r, sharp * 2), idp["eye"])
    paint(_ellipse(ys, xs, 0.55, 0.5 + shift, idp["nose_len"], 0.035,
                   sharp * 2), idp["nose"])
    paint(_ellipse(ys, xs, idp["mouth_y"], 0.5 + shift, idp["mouth_h"],
                   idp["mouth_w"] * (1 - 0.2 * abs(pose)), sharp * 2),
          idp["mouth"])
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    return resize_cv2(img, (size, size), "cubic")


def degrade_lr(gt_posed: np.ndarray, size: int, factor: int = 4) -> np.ndarray:
    """The reference LR protocol: bicubic down by `factor`, bicubic up,
    quantize to the 8-bit grid (`dataset_multipie.py:148-166`)."""
    small = _resize(gt_posed, max(2, size // factor))
    up = np.clip(_resize(small, size), 0.0, 1.0)
    return (np.round(up * 255.0) / 255.0).astype(np.float32)


def component_boxes(idp: Dict[str, np.ndarray],
                    size: int) -> Sequence[Tuple[int, int, int, int]]:
    """(top, left, bottom, right) int boxes for eye_r/eye_l/nose/mouth on
    the frontal render — the key-region masks of `get_masked_patches`
    (`dataset_kface.py:15-37`)."""
    def box(cy, cx, ry, rx):
        t = int(max(0, (cy - ry) * size))
        b = int(min(size, (cy + ry) * size + 1))
        le = int(max(0, (cx - rx) * size))
        r = int(min(size, (cx + rx) * size + 1))
        return (t, le, b, r)

    er = idp["eye_r"] * 1.5
    return [
        box(idp["eye_y"], 0.5 + idp["eye_dx"], er, er),
        box(idp["eye_y"], 0.5 - idp["eye_dx"], er, er),
        box(0.55, 0.5, idp["nose_len"] * 1.2, 0.06),
        box(idp["mouth_y"], 0.5, idp["mouth_h"] * 1.5, idp["mouth_w"] * 1.2),
    ]


class ProceduralFaceDataset(Dataset):
    """Deterministic learnable face family.

    keys may include: "lr" (degraded posed render), "gt" (frontal),
    "patches" (4 masked key-region patches of gt), "other" (frontal of a
    different identity — triplet negative), "image" (HQ frontal, for
    denoiser pretraining). Sample index -> (identity, pose) via
    index % num_ids.
    """

    def __init__(self, n: int = 64, size: int = 32,
                 keys: Sequence[str] = ("lr", "gt", "patches"),
                 num_ids: int = 8, seed: int = 0, lr_factor: int = 4,
                 start: int = 0, id_spread: float = 1.0,
                 light_jitter: float = 0.0, detail: float = 0.0,
                 clutter: int = 0, cache: bool = False):
        if not 0.0 < id_spread <= 1.0:
            # u() would extrapolate outside the valid parameter ranges
            # (colors leaving [0,1], geometry leaving the render's
            # assumptions) — reject rather than render garbage
            raise ValueError(f"id_spread must be in (0, 1], got {id_spread}")
        self.n = n
        self.size = size
        self.keys = tuple(keys)
        self.num_ids = num_ids
        self.seed = seed
        self.lr_factor = lr_factor
        # index offset: a val split with the SAME identities but disjoint,
        # never-trained poses is ProceduralFaceDataset(..., start=10_000)
        self.start = start
        # hard-identity knobs: id_spread < 1 packs the
        # identities toward the family mean (see _identity_params);
        # light_jitter > 0 applies a per-SAMPLE random RGB gain to the
        # posed INPUT render only (gt/other/image stay canonical) —
        # mimicking the reference's K-Face lighting conditions
        # (`dataset_kface.py:56` L1/L3) and defeating raw-color identity
        # shortcuts. Defaults preserve the legacy family bit-exactly.
        self.id_spread = id_spread
        self.light_jitter = light_jitter
        # detail-family knobs: detail > 0 paints the
        # per-identity facial-mark pattern (fine, identity-deterministic
        # spots the x4 degradation erases — the model must learn the
        # identity -> pattern map to restore them); clutter > 0 adds
        # per-sample sharp background shapes shared between lr and gt
        # (one scene). Both scale with resolution (face-relative units),
        # making the family's entropy — and hence step-reduction cost and
        # stage-2 hardness — real at the 128 px reference geometry
        # instead of only at 32 px. Defaults keep the legacy family.
        self.detail = detail
        self.clutter = clutter
        # optional in-memory render cache: the dataset is deterministic
        # in (seed, index), so caching is exact. The detail/clutter
        # renders cost ~8/33 ms per sample at 64/128 px — re-rendering
        # every epoch on a 1-core host would dominate a long multi-stage
        # training run (dict writes are GIL-atomic; a racing Loader
        # thread at worst renders a sample twice)
        self._cache: Dict[int, Sample] = {} if cache else None

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, index: int) -> Sample:
        if self._cache is not None:
            hit = self._cache.get(index)
            if hit is not None:
                return hit
        raw_index = index
        index = index + self.start
        ident = index % self.num_ids
        idp = _identity_params(self.seed, ident, self.id_spread)
        rng = np.random.default_rng((self.seed, 104729, index))
        pose = float(rng.uniform(-0.8, 0.8))
        marks = (_identity_marks(self.seed, ident)
                 if self.detail > 0.0 else None)
        scene = (_clutter_shapes(self.seed, index, self.clutter)
                 if self.clutter > 0 else None)
        render_kw = dict(detail=self.detail, marks=marks, clutter=scene)

        out: Sample = {}
        gt = None
        if {"gt", "patches", "image"} & set(self.keys):
            gt = render_face(idp, 0.0, self.size, **render_kw)
        if "gt" in self.keys:
            out["gt"] = gt
        if "image" in self.keys:
            out["image"] = gt
        if "lr" in self.keys:
            posed = render_face(idp, pose, self.size, **render_kw)
            if self.light_jitter > 0.0:
                # per-sample illumination nuisance on the INPUT only,
                # from an independent stream so enabling the knob leaves
                # the legacy pose/negative draws untouched
                jrng = np.random.default_rng((self.seed, 104730, index))
                gain = 1.0 + jrng.uniform(-self.light_jitter,
                                          self.light_jitter, 3)
                posed = np.clip(posed * gain, 0.0, 1.0).astype(np.float32)
            out["lr"] = degrade_lr(posed, self.size, self.lr_factor)
        if "patches" in self.keys:
            patches = np.zeros((4, self.size, self.size, 3), np.float32)
            for p, (t, le, b, r) in enumerate(component_boxes(idp,
                                                              self.size)):
                patches[p, t:b, le:r] = gt[t:b, le:r]
            out["patches"] = patches
        if "pos" in self.keys:
            # triplet POSITIVE as a DIFFERENT PHOTO of the same identity:
            # same canonical frontal + marks, but its own background scene
            # (the reference's positive is a separate frontal photograph,
            # `dataset_kface.py:184-246` — not the restoration target).
            # With clutter=0 this is bit-identical to gt, so the legacy
            # family is unchanged; with clutter>0 it removes the
            # shared-scene shortcut that would otherwise let a random
            # encoder rank the triplet by background alone.
            pos = render_face(
                idp, 0.0, self.size, detail=self.detail, marks=marks,
                clutter=(_clutter_shapes(self.seed, index + 2_000_003,
                                         self.clutter)
                         if self.clutter > 0 else None))
            if self.light_jitter > 0.0:
                # a different photo also has its own illumination
                # (independent stream; the K-Face positives span the
                # L1/L3 lighting conditions, `dataset_kface.py:56`)
                prng = np.random.default_rng((self.seed, 104733, index))
                gain = 1.0 + prng.uniform(-self.light_jitter,
                                          self.light_jitter, 3)
                pos = np.clip(pos * gain, 0.0, 1.0).astype(np.float32)
            out["pos"] = pos
        if "other" in self.keys:
            other = (ident + 1 + int(rng.integers(0, self.num_ids - 1))) \
                % self.num_ids
            neg = render_face(
                _identity_params(self.seed, other, self.id_spread),
                0.0, self.size, detail=self.detail,
                marks=(_identity_marks(self.seed, other)
                       if self.detail > 0.0 else None),
                # the negative is a DIFFERENT photo: its own background
                clutter=(_clutter_shapes(self.seed, index + 1_000_003,
                                         self.clutter)
                         if self.clutter > 0 else None))
            if self.light_jitter > 0.0:
                # ... and its own illumination (independent stream;
                # symmetric with "pos" so ranking cannot key on which
                # side carries the lighting nuisance)
                nrng = np.random.default_rng((self.seed, 104734, index))
                gain = 1.0 + nrng.uniform(-self.light_jitter,
                                          self.light_jitter, 3)
                neg = np.clip(neg * gain, 0.0, 1.0).astype(np.float32)
            out["other"] = neg
        if self._cache is not None:
            self._cache[raw_index] = out
        return out
