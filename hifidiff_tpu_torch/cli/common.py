"""Shared CLI machinery (counterpart of hifidiff_tpu/cli/common.py): typed
dataclass configs -> argparse flags, the smoke datasets, the model stack
built from a config's size knobs, its weights read from checkpoint files, and
what the training CLIs share (the refusals, resume, the module to
evaluate, and under torchrun the process group, the dataset's shard and the
sampler's global noise; the batch copy to the card is
`parallel.mesh.to_device`, the global metrics `parallel.global_means`).

Checkpoints the port reads:
  * torch files (`.pt` / `.pth`) holding a state dict in the HifiDiff
    reference's names (the VAE: diffusers' names), also inside the
    reference's `{"model_state_dict": ...}` wrapper;
  * the port's own `train/checkpoint.save_state` files (the module's state
    dict is read, the optimizer's is not), and a training CLI's checkpoint
    directory of them (`CheckpointManager`: its latest step is read), which
    is what one stage hands the next;
  * `.safetensors` files, where the `safetensors` package imports.
The refiner's file is either a whole FacialRefiner (names under
`denoiser.`, `fpg.` and `idc.`; every name must load) or a stage-3
Denoiser, composed into the refiner by `train/checkpoint.compose_refiner`.
An orbax checkpoint directory of the JAX package cannot be read without JAX,
and is refused.

Without a checkpoint a network keeps its seeded random init, with a warning.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import os
from typing import (Callable, Dict, Iterator, Optional, Type, TypeVar,
                    Union)

import numpy as np
import torch

from hifidiff_tpu_torch.data.core import Dataset, Sample
from hifidiff_tpu_torch.devices import resolve_device

T = TypeVar("T")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def add_dataclass_args(parser: argparse.ArgumentParser, cls: Type[T]) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        if f.type in ("bool", bool):
            parser.add_argument(name, type=lambda s: s.lower() in
                                ("1", "true", "yes"),
                                default=f.default, metavar="BOOL")
        else:
            ftype = {int: int, float: float, str: str}.get(f.type, str) \
                if not isinstance(f.type, str) else \
                {"int": int, "float": float, "str": str,
                 "Optional[str]": str, "Optional[int]": int}.get(f.type, str)
            parser.add_argument(name, type=ftype, default=f.default)


def parse_config(cls: Type[T], argv=None, description: str = "") -> T:
    parser = argparse.ArgumentParser(description=description)
    add_dataclass_args(parser, cls)
    args = parser.parse_args(argv)
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)})


def parse_ints(s: str) -> tuple:
    """'2,2,4,8' -> (2, 2, 4, 8) for depth/width-list flags."""
    return tuple(int(x) for x in str(s).split(",") if x.strip())


def model_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{name!r}")
    return DTYPES[name]


def seeded_generator(seed: int, counter: int,
                     device: Union[str, torch.device]) -> torch.Generator:
    """A `torch.Generator` on `device` seeded from (seed, counter) through
    numpy's SeedSequence: the counterpart of the JAX package's
    `fold_in(PRNGKey(seed), counter)`, one independent stream per launch or
    batch."""
    state = np.random.SeedSequence([seed, counter]).generate_state(
        1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(state[0]))


@contextlib.contextmanager
def seeded(seed: int) -> Iterator[None]:
    """Modules built inside take their init from `seed`; the global torch
    RNG is left as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        yield


def require_data(cfg, roots) -> None:
    """The CLIs' "give one of" check: without generated data (`--synthetic
    N` or `--procedural N`) one of the dataset flags `roots` (Config field
    names) must be set."""
    if not (cfg.synthetic or cfg.procedural
            or any(getattr(cfg, f) for f in roots)):
        wanted = " or ".join(["--synthetic N", "--procedural N"]
                             + ["--" + f.replace("_", "-") for f in roots])
        raise ValueError(f"give {wanted}")


def multipie_datasets(cfg, use_patch: bool = False):
    """The `--dataroot` Multi-PIE splits as the JAX training CLIs build
    them: the train split through the blind branch, the test split
    without, at `cfg.size`, `cfg.model_type` and `cfg.seed`."""
    from hifidiff_tpu_torch.data.multipie import MultiPIEDataset

    kw = dict(model_type=cfg.model_type, size=cfg.size, use_patch=use_patch,
              seed=cfg.seed)
    return (MultiPIEDataset(cfg.dataroot, split="train", use_blind=True,
                            **kw),
            MultiPIEDataset(cfg.dataroot, split="test", use_blind=False,
                            **kw))


def hq_datasets(cfg):
    """The image datasets of `--multipie-root` (its train split) and
    `--celeba-root` at `cfg.size`, concatenated, as the JAX CLIs build them
    for the VAE, the denoiser and the tiny autoencoder."""
    from hifidiff_tpu_torch.data.core import ConcatDataset
    from hifidiff_tpu_torch.data.pretraining import (CelebAHQDataset,
                                                     MultiPIEHQDataset)

    parts = []
    if cfg.multipie_root:
        parts.append(MultiPIEHQDataset(cfg.multipie_root, size=cfg.size))
    if cfg.celeba_root:
        parts.append(CelebAHQDataset(cfg.celeba_root, size=cfg.size))
    if not parts:
        raise ValueError("need --multipie-root and/or --celeba-root")
    return ConcatDataset(parts)


def data_parallel(cfg, who: str):
    """A CLI's start under `torchrun --nproc_per_node N` (or alone): start
    the process group where the launcher asks for one
    (`parallel.maybe_initialize`, nccl on the card, gloo with `--device
    cpu`), then resolve the device: the rank's card `cuda:LOCAL_RANK`
    unless `--device cpu`, raising without a card. Returns (device, group):
    the data-parallel group, None for a single process."""
    from hifidiff_tpu_torch.parallel.distributed import maybe_initialize

    up = maybe_initialize(device=cfg.device)
    device = resolve_device(cfg.device, who)
    if getattr(cfg, "cuda_graphs", False) and device.type != "cuda":
        raise ValueError(f"{who}: --cuda-graphs captures the train step as "
                         "CUDA graphs, which needs the card; the run is on "
                         f"{device}")
    group = torch.distributed.group.WORLD if up else None
    return device, group


def graphed(cfg, step: Callable) -> Callable:
    """The train step a CLI's loop calls: `step` itself, or with
    `--cuda-graphs` a callable with `step`'s arguments that captures it
    (`train.graphs.capture_train_step`, after `resume`: the loop's first
    call, whose step is the capture's warm-up) on the first batch of each
    shape, an epoch's short last batch getting a capture of its own, and
    replays it. The distillation steps'
    teacher (the argument before the batch) is frozen state of the
    capture. A state that changed under a capture makes the replay raise."""
    if not cfg.cuda_graphs:
        return step
    from hifidiff_tpu_torch.train.graphs import (batch_signature,
                                                 capture_train_step)

    captures = {}

    def run(state, *args, generator=None, **draws):
        *teacher, batch = args
        key = (id(state), batch_signature(batch))
        if key not in captures:
            print(f"--cuda-graphs: capturing the train step at step "
                  f"{state.step} for batches of {key[1]}")
            captures[key] = capture_train_step(
                step, state, batch, teacher=teacher[0] if teacher else None)
        return captures[key].run(batch, generator=generator, **draws)

    return run


def shard() -> Dict[str, int]:
    """`Loader` arguments for this process's shard of a dataset: disjoint
    stride-slices of one seeded order, padded so that every process yields
    the same batches (`batch_size` stays per process, the JAX CLIs'
    convention). One process: the whole dataset."""
    from hifidiff_tpu_torch.parallel.distributed import (process_count,
                                                         process_index)

    return {"shard_index": process_index(), "num_shards": process_count()}


def sampler_noise(sampler, batch: int, generator: torch.Generator,
                  group) -> Dict[str, Optional[torch.Tensor]]:
    """The noise a `RefinerSampler` call on `batch` rows draws from
    `generator` (posterior noise first, where the sampler samples it), as
    keyword arguments of the call. Under data parallelism each process
    draws the global batch's noise and takes its rows, so that the run's
    faces are one process's on the concatenated batch; without a group the
    sampler draws its own from the generator."""
    if group is None:
        return {"generator": generator}
    from hifidiff_tpu_torch.parallel.distributed import global_rows

    inputs = sampler._inputs
    size = inputs.config.latent_size
    shape = (batch, size, size, inputs.channels)

    def draw():
        return global_rows(lambda s: torch.randn(
            s, generator=generator, device=generator.device), shape, group)

    post = draw() if inputs.needs_posterior else None
    return {"posterior_noise": post, "latents_noise": draw()}


def to_nhwc(images: torch.Tensor) -> np.ndarray:
    """NCHW images on any device -> a float32 NHWC numpy array (for the
    grids)."""
    return images.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def resume(cfg, ckpt, state, loader) -> int:
    """With `cfg.resume` and a checkpoint in `ckpt`, restore the latest into
    `state`. Returns the epoch to start at, and sets the loader's epoch to
    it, so that a resumed run draws the uninterrupted run's shuffles (the
    JAX CLIs leave their loader at epoch 0, ROADMAP §C)."""
    from hifidiff_tpu_torch.parallel.distributed import barrier

    start = 0
    barrier()   # rank 0 has written what the other ranks read
    if cfg.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        start = state.step // max(1, len(loader))
        print(f"resumed at step {state.step} (epoch {start})")
    loader.epoch = start
    return start


class EvalModule:
    """What a training CLI evaluates: the module under training, or, with an
    EMA, a copy that `__call__` fills with the EMA parameters and the live
    buffers (the JAX CLIs' `state.eval_params`). Either way it is returned
    in eval mode; the next train step puts the live module back in training
    mode."""

    def __init__(self, state):
        self.state = state
        self.module = state.module if state.ema_params is None \
            else copy.deepcopy(state.module)

    @torch.no_grad()
    def __call__(self) -> torch.nn.Module:
        live = self.state.module
        if self.module is not live:
            for n, p in self.module.named_parameters():
                p.copy_(self.state.ema_params[n])
            for n, b in self.module.named_buffers():
                b.copy_(live.get_buffer(n))
        return self.module.eval()


def smoke_datasets(cfg, keys, val_keys=None):
    """Train / val datasets for the two no-real-data modes: `--synthetic N`
    (random arrays, shapes only) and `--procedural N` (the learnable face
    family of `data/procedural.py`), split as the JAX package's
    `smoke_datasets` splits them: for pose-dependent keys ("lr" present) val
    is the same identities at poses never trained (`start=10_000`); for
    image-only keys val uses unseen identities (another seed). Returns None
    when neither flag is set."""
    if getattr(cfg, "procedural", 0):
        from hifidiff_tpu_torch.data.procedural import ProceduralFaceDataset

        n_val = max(4, cfg.procedural // 4)
        pose_dependent = "lr" in set(val_keys or keys)
        hard_kw = dict(
            id_spread=getattr(cfg, "proc_id_spread", 1.0),
            light_jitter=getattr(cfg, "proc_light_jitter", 0.0),
            detail=getattr(cfg, "proc_detail", 0.0),
            clutter=getattr(cfg, "proc_clutter", 0))
        if pose_dependent:
            # the hard family scales its identities with the set size, so
            # that each identity still gets ~16 poses
            hard = hard_kw["id_spread"] < 1.0 or hard_kw["detail"] > 0.0
            num_ids = max(8, cfg.procedural // 16) if hard else 8
        else:
            num_ids = max(8, cfg.procedural // 4)
        val_kw = (dict(seed=cfg.seed, start=10_000) if pose_dependent
                  else dict(seed=cfg.seed + 7919))
        return (ProceduralFaceDataset(cfg.procedural, cfg.size, keys=keys,
                                      num_ids=num_ids, seed=cfg.seed,
                                      cache=True, **hard_kw),
                ProceduralFaceDataset(n_val, cfg.size, num_ids=num_ids,
                                      keys=val_keys or keys, cache=True,
                                      **val_kw, **hard_kw))
    if cfg.synthetic:
        def make(n, k):
            return SyntheticFaceDataset(n, cfg.size, keys=k, seed=cfg.seed)

        return (make(cfg.synthetic, keys),
                make(max(4, cfg.synthetic // 4), val_keys or keys))
    return None


class SyntheticFaceDataset(Dataset):
    """Random face-shaped samples for smoke runs, the same arrays as the JAX
    package's for a seed. Keys configurable to mimic each real dataset's
    sample dict."""

    def __init__(self, n: int = 64, size: int = 128, keys=("lr", "gt"),
                 num_patches: int = 4, seed: int = 0):
        self.n = n
        self.size = size
        self.keys = keys
        self.num_patches = num_patches
        self.seed = seed

    def __len__(self):
        return self.n

    def __getitem__(self, index: int) -> Sample:
        rng = np.random.default_rng((self.seed, index))
        out: Sample = {}
        for k in self.keys:
            if k == "patches":
                patches = np.zeros(
                    (self.num_patches, self.size, self.size, 3), np.float32)
                for p in range(self.num_patches):
                    t0, l0 = rng.integers(0, self.size - 16, 2)
                    patches[p, t0:t0 + 16, l0:l0 + 16] = rng.uniform(
                        0, 1, (16, 16, 3))
                out[k] = patches
            else:
                out[k] = rng.uniform(0, 1, (self.size, self.size, 3)).astype(
                    np.float32)
        return out


def build_refiner_models(cfg):
    """The CR / VAE / FacialRefiner modules from cfg's model-size knobs, on
    the CPU in float32 with their init drawn from `cfg.seed` (the global
    torch RNG is left as it was; `cfg.remat`, where the config has it,
    goes to the refiner). Returns (cr, vae, refiner, latent), latent being
    the latent map's side."""
    from hifidiff_tpu_torch.models.refiner import FacialRefiner
    from hifidiff_tpu_torch.vae.model import AutoencoderKL

    vae_blocks = parse_ints(cfg.vae_blocks)
    latent = cfg.size // (2 ** (len(vae_blocks) - 1))
    with seeded(cfg.seed):
        cr = build_cr(cfg.cr_width, cfg.size, cfg.cr_enc_depths,
                      cfg.cr_mid_depth)
        vae = AutoencoderKL(block_out=vae_blocks,
                            layers_per_block=cfg.vae_layers)
        refiner = FacialRefiner(latent_size=latent, width=cfg.width,
                                enc_nums=parse_ints(cfg.enc_depths),
                                mid_num=cfg.mid_depth,
                                dec_nums=parse_ints(cfg.dec_depths),
                                idc_stage_sizes=parse_ints(cfg.idc_stages),
                                remat=getattr(cfg, "remat", False))
    return cr, vae, refiner, latent


def build_cr(width: int, size: int, enc_depths: str, mid_depth: int):
    """The CR of these size flags; its decoder has two blocks a level, as
    the JAX package builds it."""
    from hifidiff_tpu_torch.models.cr import CoarseRestoration

    enc = parse_ints(enc_depths)
    return CoarseRestoration(width=width, resolution=size, enc_nums=enc,
                             mid_num=mid_depth, dec_nums=(2,) * len(enc))


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A checkpoint file, or the latest file of a training CLI's checkpoint
    directory, as a flat state dict (see the module's docstring for the
    formats); raises on any other directory (an orbax one) and on a
    `.safetensors` file without the `safetensors` package."""
    if os.path.isdir(path):
        from hifidiff_tpu_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(path, create=False)
        if ckpt.latest_step() is not None:
            return read_state_dict(ckpt.path(ckpt.latest_step()))
        raise ValueError(
            f"{path} is a directory (an orbax checkpoint of the JAX "
            "package?): the port cannot read orbax without JAX. Give a torch "
            "file (.pt / .pth: a state dict in the reference's names, or a "
            "train/checkpoint.save_state file), or a .safetensors file")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    if path.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise RuntimeError(
                f"{path}: reading .safetensors needs the safetensors "
                "package, which is not installed; give a torch file "
                "(.pt / .pth)") from e
        return dict(load_file(path))
    from hifidiff_tpu_torch.train.checkpoint import load_state_dict_file

    sd = load_state_dict_file(path)
    state = sd.get("state") if isinstance(sd, dict) else None
    if isinstance(state, dict) and "module" in state:
        sd = state["module"]    # a train/checkpoint.save_state file
    return sd


def _load_strict(module: torch.nn.Module, sd, what: str, path: str) -> None:
    missing, unexpected = module.load_state_dict(sd, strict=False)
    if missing or unexpected:
        raise ValueError(f"{what} checkpoint {path} does not fit the "
                         f"configured model: missing {missing[:8]}, "
                         f"unexpected {unexpected[:8]}")


def load_weights(module: torch.nn.Module, path: str,
                 what: str) -> torch.nn.Module:
    """Load a frozen stage's weights strictly from `path` (a file or a
    training CLI's checkpoint directory; the formats of the module's
    docstring), or keep the seeded random init with a warning when `path`
    is empty; returns `module`."""
    if path:
        _load_strict(module, read_state_dict(path), what, path)
        print(f"loaded {what} weights from {path}")
    else:
        print(f"[warn] no checkpoint: the {what} is randomly initialized")
    return module


def load_vae(vae: torch.nn.Module, path: str, seed: int) -> torch.nn.Module:
    """`load_weights` for the frozen VAE; without a checkpoint it is drawn
    from `seed` as the JAX CLIs' `vae.init` draws it
    (`vae.model.flax_default_init_`)."""
    from hifidiff_tpu_torch.vae.model import flax_default_init_

    if not path:
        with seeded(seed):
            flax_default_init_(vae)
    return load_weights(vae, path, "VAE")


def _load_refiner(refiner: torch.nn.Module, path: str) -> None:
    from hifidiff_tpu_torch.train.checkpoint import compose_refiner

    sd = read_state_dict(path)
    loaded = compose_refiner(refiner, denoiser=sd)
    if any(k.startswith(("denoiser.", "fpg.", "idc.")) for k in sd):
        names = {f"{part}.{n}" for part, got in loaded.items() for n in got}
        left = sorted(set(refiner.state_dict()) - names)
        if left:
            raise ValueError(f"refiner checkpoint {path} does not fit the "
                             f"configured model: {len(left)} names not "
                             f"loaded, e.g. {left[:8]}")
    elif not loaded["denoiser"]:
        raise ValueError(f"refiner checkpoint {path}: no name of the "
                         "denoiser loaded")
    print(f"loaded refiner weights from {path} ("
          + ", ".join(f"{k} {len(v)}" for k, v in loaded.items()) + ")")


def load_refiner_stack(cfg, device: Union[str, torch.device],
                       dtype: torch.dtype = torch.float32):
    """The CR / VAE / FacialRefiner stack from cfg's size knobs with the
    weights of its checkpoint fields (refiner_ckpt, cr_ckpt, vae_ckpt; the
    formats of the module's docstring; random init with a warning where a
    field is empty), cast to `dtype`, on `device`, in eval mode. Shared by
    `test_refiner` and `serve`. Returns (cr, vae, refiner, latent)."""
    cr, vae, refiner, latent = build_refiner_models(cfg)
    if cfg.refiner_ckpt:
        _load_refiner(refiner, cfg.refiner_ckpt)
    else:
        print("[warn] random refiner weights")
    load_weights(cr, cfg.cr_ckpt, "CR")
    load_vae(vae, cfg.vae_ckpt, cfg.seed)
    for m in (cr, vae, refiner):
        m.to(device, dtype).eval()
    return cr, vae, refiner, latent


def load_tiny_seams(cfg, latent: int, device: Union[str, torch.device],
                    dtype: torch.dtype = torch.float32
                    ) -> Dict[str, Optional[torch.nn.Module]]:
    """The tiny modules the config asks for, with their weights, for the
    split sampler's `tiny_enc` / `tiny_dec` / `tiny_cr` arguments (None
    where not asked for). `tae_ckpt`: one state-dict file of the tiny
    autoencoder, the decoder's names under `dec.` and the encoder's under
    `enc.` (`tae_mode` "decode" uses only the decoder); `tiny_cr_ckpt`: a
    TinyCR state-dict file of the configured width, blocks and down factor.
    Both load strictly."""
    seams: Dict[str, Optional[torch.nn.Module]] = dict(
        tiny_enc=None, tiny_dec=None, tiny_cr=None)
    if cfg.tae_ckpt:
        from hifidiff_tpu_torch.vae.tiny import tiny_autoencoder_pair

        if cfg.tae_mode not in ("decode", "both"):
            raise ValueError(f"tae_mode must be 'decode' or 'both', got "
                             f"{cfg.tae_mode!r}")
        enc, dec = tiny_autoencoder_pair(cfg.size // latent)
        sd = read_state_dict(cfg.tae_ckpt)
        pair = torch.nn.ModuleDict({"enc": enc, "dec": dec})
        _load_strict(pair, sd, "tiny autoencoder", cfg.tae_ckpt)
        seams["tiny_dec"] = dec
        if cfg.tae_mode == "both":
            seams["tiny_enc"] = enc
        print(f"tiny autoencoder ({cfg.tae_mode}) from {cfg.tae_ckpt}")
    if cfg.tiny_cr_ckpt:
        from hifidiff_tpu_torch.models.tiny_cr import TinyCR

        tiny_cr = TinyCR(width=cfg.tiny_cr_width, blocks=cfg.tiny_cr_blocks,
                         down_factor=cfg.tiny_cr_down)
        _load_strict(tiny_cr, read_state_dict(cfg.tiny_cr_ckpt), "tiny CR",
                     cfg.tiny_cr_ckpt)
        seams["tiny_cr"] = tiny_cr
        print(f"tiny CR from {cfg.tiny_cr_ckpt}")
    for m in seams.values():
        if m is not None:
            m.to(device, dtype).eval()
    return seams
