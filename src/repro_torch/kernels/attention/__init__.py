"""Attention: flash_attention (csrc/flash.cu) and its plain versions."""
