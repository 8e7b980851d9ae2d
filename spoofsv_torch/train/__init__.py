"""Training layer of the port: losses, ordinary and adversarial steps, states, trainer."""

from spoofsv_torch.train.loop import (  # noqa: F401
    CheckpointManager,
    MetricsLogger,
    Trainer,
    make_ar_validator,
    make_ssrn_validator,
    plot_attention,
    plot_losses,
)
from spoofsv_torch.train.losses import (  # noqa: F401
    binary_divergence,
    guided_attention_loss,
    guided_attention_matrix,
    l1_loss,
    ssrn_losses,
    text2mel_losses,
)
from spoofsv_torch.train.state import AdvTrainState, TrainState  # noqa: F401
from spoofsv_torch.train.steps import (  # noqa: F401
    clip_weights,
    draw_mixing,
    is_g_step,
    make_adversarial_steps,
    make_eval_step,
    make_fused_adversarial_step,
    make_optimizer,
    make_ordinary_step,
    shift_right,
)
