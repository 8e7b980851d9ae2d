"""Host-side utilities of the port (:mod:`spoofsv_torch.utils.profiling`,
:mod:`spoofsv_torch.utils.plot`)."""
