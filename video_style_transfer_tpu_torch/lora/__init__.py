"""UnZipLoRA spatial LoRAs, the temporal LoRA and the param-tree surgery
that inserts them (the JAX package's lora/ counterpart; artifact interop
and the serving-time fold come with the loader slice)."""
