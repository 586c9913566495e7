"""The Mamba-2 SSD scan: ssd_log / ssd (csrc/ssd.cu) and its plain versions."""
