"""Plain float32 PyTorch that decides ``correct``: the towers, the CrossCLR
intra loss and optax's AdamW, written after the port's documented
semantics.  It imports nothing of ``crossclr_tpu_torch`` and takes
nothing the program made: the harness hands it the weights and inputs it
made itself, and the program's outputs only to judge them."""
