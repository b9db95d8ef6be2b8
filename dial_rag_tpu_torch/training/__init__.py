from dial_rag_tpu_torch.training.contrastive import (
    TrainState,
    contrastive_loss,
    create_train_state,
    make_train_step,
)

__all__ = [
    "TrainState",
    "contrastive_loss",
    "create_train_state",
    "make_train_step",
]
