"""repro_torch.configs — operating points: the paper's own workload
(``psram_mttkrp``) and every LM architecture of the reference — dense
(``granite_8b``, ``deepseek_7b``, ``chatglm3_6b``, ``gemma2_27b``), dense
with M-RoPE (``qwen2_vl_7b``), MoE (``granite_moe_1b_a400m``,
``dbrx_132b``), SSM (``mamba2_370m``), hybrid (``jamba_1p5_large``) and
encoder-decoder (``seamless_m4t_large_v2``) — each the reference's exact
public config."""
