"""Plain float32 references of what the cells run: plain PyTorch ops, no kernels,
no captured graphs, nothing imported from the port."""
