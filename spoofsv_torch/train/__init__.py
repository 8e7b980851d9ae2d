"""Training layer of the port, ordinary path: losses, steps, state, trainer."""

from spoofsv_torch.train.loop import (  # noqa: F401
    CheckpointManager,
    MetricsLogger,
    Trainer,
    make_ar_validator,
    make_ssrn_validator,
)
from spoofsv_torch.train.losses import (  # noqa: F401
    binary_divergence,
    guided_attention_loss,
    guided_attention_matrix,
    l1_loss,
    ssrn_losses,
    text2mel_losses,
)
from spoofsv_torch.train.state import TrainState  # noqa: F401
from spoofsv_torch.train.steps import (  # noqa: F401
    make_eval_step,
    make_optimizer,
    make_ordinary_step,
    shift_right,
)
