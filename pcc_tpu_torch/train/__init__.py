from pcc_tpu_torch.train.checkpoint import (
    export_inference_params,
    load_latest_checkpoint,
    save_checkpoint,
)
from pcc_tpu_torch.train.state import TrainState, create_train_state
from pcc_tpu_torch.train.steps import build_train_step
from pcc_tpu_torch.train.steps_pppf import build_pppf_train_step

__all__ = [
    "TrainState",
    "create_train_state",
    "build_train_step",
    "build_pppf_train_step",
    "save_checkpoint",
    "load_latest_checkpoint",
    "export_inference_params",
]
