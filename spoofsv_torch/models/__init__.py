from spoofsv_torch.models.discriminator import Critic1D, LinDisc, MelDisc
from spoofsv_torch.models.ge2e import GE2ELoss, SpeechEmbedder
from spoofsv_torch.models.ssrn import SSRN
from spoofsv_torch.models.text2mel import MelSyn

__all__ = ["Critic1D", "GE2ELoss", "LinDisc", "MelDisc", "MelSyn", "SSRN", "SpeechEmbedder"]
