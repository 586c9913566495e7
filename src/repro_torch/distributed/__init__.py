"""Multi-device coadd jobs on ``torch.distributed`` (`sharding`)."""
