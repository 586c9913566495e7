"""The warp stage: warp_project and coadd_fused (csrc/warp.cu)."""
