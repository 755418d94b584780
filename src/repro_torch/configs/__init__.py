"""repro_torch.configs — operating points: the paper's own workload
(``psram_mttkrp``) and the dense LM architectures the port builds
(``granite_8b``, ``deepseek_7b``, ``chatglm3_6b``, ``gemma2_27b``), each the
reference's exact public config. The MoE, hybrid, SSM, encoder-decoder and
M-RoPE configs come with their families (``models.registry`` says which
ROADMAP item)."""
