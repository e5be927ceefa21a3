"""Single config tree for every ROVR workload, PyTorch port.

The port's own copy of `rovr_tpu/config.py`: the same frozen dataclass tree,
field for field and with the same defaults, so a config built for one package
can be rebuilt for the other with `dataclasses.asdict`. The port keeps its own
copy rather than importing the JAX package's, so that `rovr_torch` runs where
JAX is not installed. The port's entry points reject the options they do
not run. See the JAX file for the history behind each knob.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Input pipeline (video_ds.py / video_ds_explicit.py semantics)."""

    root_folder: str = "out/LQ"
    frames_per_clip: int = 50
    vid_length: int = 20
    frame_size: Tuple[int, int] = (256, 256)  # H, W
    # Corruption (video_ds.py:18-89)
    difficulty: int = 2
    brightness: int = 40
    noise: int = 20
    apply_jitter_box: bool = False
    debug_short_dataset: bool = False
    # Host-side pipeline
    num_workers: int = 8
    prefetch_depth: int = 2
    use_native_loader: bool = True
    stage_uint8: bool = False
    synthetic_overlap_free: bool = False
    # "explicit" (teacher group masks) or "raster" (deterministic raster box)
    synthetic_scheme: str = "explicit"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model-zoo dimensions."""

    # Local inpainting UNet: enc 9->64->128->256->512.
    local_net_channels: Tuple[int, ...] = (64, 128, 256, 512)
    # Policy 1 frame-selection UNet.
    pn1_channels: Tuple[int, ...] = (32, 64, 128, 256)
    pn1_num_frames: int = 25
    pn1_temperature: float = 0.5
    # Policy 2 context-selection net.
    pn2_num_frames: int = 20
    pn2_temperature: float = 0.7
    pn2_fc_dims: Tuple[int, ...] = (1024, 512, 256, 64)
    # True: the policy trunks' batch-stat norms reduce per SAMPLE, so a
    # clip's context selection does not depend on its batchmates.
    per_sample_stats: bool = False
    # VideoProcessor state canvas: single-channel canvas of square tiles.
    canvas_size: int = 160
    canvas_tile: int = 32
    canvas_tiles_per_row: int = 5
    feature_dim: int = 1024
    # ActionLSTM
    lstm_hidden_dim: int = 1024
    # Attention context policy
    attn_hidden_dim: int = 256
    attn_heads: int = 4
    attn_depth: int = 2
    attn_patch_tokens: int = 4
    attn_impl: str = "auto"
    attn_pp_microbatches: int = 0
    attn_moe_experts: int = 0
    attn_moe_capacity: float = 1.25
    # Compute dtype for conv/matmul-heavy paths. Params stay float32.
    compute_dtype: str = "bfloat16"
    # Feature-extractor trunk: "resnet50" or "tiny" (small trunk for tests).
    backbone: str = "resnet50"
    # 1 = global average pool; g > 1 pools the final map to a (g, g) grid.
    backbone_spatial_pool: int = 1
    # LPIPS VGG stage plan ((features, n_convs) per stage); None = VGG16.
    lpips_stages: Optional[Tuple[Tuple[int, int], ...]] = None
    # Rollout LPIPS tap cache split: original-frame taps of stages >= this
    # index are cached for the episode; earlier stages are recomputed per
    # step for the gathered targets (a prefix of the same trunk).
    lpips_cache_from_stage: int = 0
    # > 0: the episode-init LPIPS pass runs over S in chunks of this many
    # frames, bounding its transient taps (needs vid_length % chunk == 0).
    lpips_init_chunk: int = 0


@dataclasses.dataclass(frozen=True)
class RLConfig:
    """PPO / rollout hyperparameters (rovr.py:26-60)."""

    vid_length: int = 20
    time_steps: int = 20
    n_updates_per_ppo: int = 5
    batch_size: int = 1
    use_policy1: bool = False
    ppo_policy1: bool = False
    # "canvas" (PolicyNet2 over the state canvas) or "attention"
    context_policy: str = "canvas"
    clip: float = 0.2
    gamma: float = 1.0
    actor_lr: float = 2e-4
    critic_lr: float = 2e-4
    use_spatio_reward: bool = False
    log_spatio: bool = False
    spatio_scale: float = 7.5
    spatio_flow_size: int = 256
    # Gather UNet inputs from the evolving reconstruction instead of the
    # immutable corrupted video (a documented deviation; parity is False).
    recon_context: bool = False
    # Second (sequential-context) UNet pass per step, for evaluation.
    sequential_baseline: bool = False
    # Deterministic (no-Gumbel) top-2 context selection in the rollout.
    greedy: bool = False
    eval_greedy: bool = True
    # XLA scan knobs of the JAX package; the port's rollout is a Python loop.
    unroll_scans: bool = False
    scan_unroll: int = 1


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Local-net supervised pretrain (train_local_net_unet.py)."""

    batch_size: int = 24
    lr: float = 1e-4
    gamma_floor: float = 0.1
    gamma_scale: float = 0.9
    gamma_decay: float = 0.9993
    legacy_target_offset: bool = False
    viz_every: int = 200
    checkpoint_every: int = 2000
    steps: int = 10_000


@dataclasses.dataclass(frozen=True)
class ImitationConfig:
    """Policy-2 warm start (imitation_learning.py)."""

    lr: float = 2e-4
    positive_weight: float = 1.5
    negative_weight: float = 1.0
    checkpoint_every: int = 250
    steps: int = 1000
    train_vp: bool = True
    loss_mode: str = "bce"


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device mesh / sharding."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 1
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Checkpoint/metrics plumbing."""

    run_dir: str = "runs"
    experiment: str = "rovr"
    restore_from: Optional[str] = None
    checkpoint_every: int = 1
    log_every: int = 1
    seed: int = 0
    max_iterations: int = 400


@dataclasses.dataclass(frozen=True)
class Config:
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    rl: RLConfig = dataclasses.field(default_factory=RLConfig)
    pretrain: PretrainConfig = dataclasses.field(default_factory=PretrainConfig)
    imitation: ImitationConfig = dataclasses.field(default_factory=ImitationConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    run: RunConfig = dataclasses.field(default_factory=RunConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# The five workload configs as values.

def config_pretrain() -> Config:
    """1: local_net UNet supervised inpainting on masked clips."""
    return Config()


def config_eval() -> Config:
    """2: extractor + local_net reconstruction eval (no RL)."""
    return Config()


def config_imitation() -> Config:
    """3: imitation warm-start of the context policy."""
    return Config()


def config_rl(vid_length: int = 16) -> Config:
    """4: full RL loop over 16-frame clips."""
    c = Config()
    return c.replace(
        rl=dataclasses.replace(c.rl, vid_length=vid_length, time_steps=vid_length),
        data=dataclasses.replace(c.data, vid_length=vid_length),
        model=dataclasses.replace(
            c.model, pn2_num_frames=vid_length, pn1_num_frames=vid_length
        ),
    )


def config_rl_scaled(vid_length: int = 64, data_parallel: int = 8) -> Config:
    """5: long-horizon batched rollouts, clip batch data-parallel, the
    attention context policy over frame-patch tokens."""
    c = config_rl(vid_length)
    tiles_per_row = 8  # room for 64 frames on the canvas
    return c.replace(
        mesh=dataclasses.replace(c.mesh, data_parallel=data_parallel),
        rl=dataclasses.replace(
            c.rl, context_policy="attention", batch_size=data_parallel
        ),
        model=dataclasses.replace(
            c.model,
            canvas_tiles_per_row=tiles_per_row,
            canvas_size=tiles_per_row * c.model.canvas_tile,
        ),
    )


def from_dict(d: dict) -> Config:
    """Rebuild a Config from `dataclasses.asdict` of this tree or of the JAX
    package's identical one."""
    kinds = {
        "data": DataConfig, "model": ModelConfig, "rl": RLConfig,
        "pretrain": PretrainConfig, "imitation": ImitationConfig,
        "mesh": MeshConfig, "run": RunConfig,
    }
    return Config(**{k: kind(**d[k]) for k, kind in kinds.items()})
