"""repro_torch.serve — the serving tier.  This slice holds only
:mod:`.faults`, which the resolution cache imports for its fault hooks;
the daemon, client and workers arrive with the serving-tier slice."""
