from spoofsv_torch.models.ssrn import SSRN
from spoofsv_torch.models.text2mel import MelSyn

__all__ = ["MelSyn", "SSRN"]
