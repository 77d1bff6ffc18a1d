from repro_torch.comm import (
    CommMetrics,
    CommState,
    CompressionConfig,
    Mixer,
    ScheduleConfig,
)
from repro_torch.core.api import DecentralizedTrainer, run_segments
from repro_torch.core.consensus import (
    DenseMixer,
    GossipMixer,
    HubMixer,
    IdentityMixer,
    RepeatMixer,
    make_dense_mixer,
    make_gossip_mixer,
    make_hub_mixer,
    make_identity_mixer,
    repeat_mixer,
)
from repro_torch.core.drdsgd import (
    DecentralizedState,
    TrainStepConfig,
    build_eval_step,
    build_train_step,
    init_state,
    replicate_params,
)
from repro_torch.core.robust import (
    RobustConfig,
    mixture_weights,
    robust_objective,
    robust_scale,
)
from repro_torch.core.spec import (
    TrainerSpec,
    add_compression_cli_args,
    add_dynamics_cli_args,
    add_obs_cli_args,
    compression_from_args,
)

__all__ = [
    "CommMetrics", "CommState", "CompressionConfig", "Mixer", "ScheduleConfig",
    "DecentralizedTrainer", "run_segments", "DenseMixer", "GossipMixer",
    "HubMixer", "IdentityMixer", "RepeatMixer", "make_dense_mixer", "make_gossip_mixer",
    "make_hub_mixer", "make_identity_mixer", "repeat_mixer", "DecentralizedState",
    "TrainStepConfig", "build_eval_step", "build_train_step", "init_state",
    "replicate_params", "RobustConfig", "mixture_weights", "robust_objective",
    "robust_scale", "TrainerSpec", "add_compression_cli_args", "add_dynamics_cli_args",
    "add_obs_cli_args", "compression_from_args",
]
