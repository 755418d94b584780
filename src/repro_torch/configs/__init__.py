"""repro_torch.configs — operating points: the paper's own workload
(``psram_mttkrp``) and the LM architectures the port builds — dense
(``granite_8b``, ``deepseek_7b``, ``chatglm3_6b``, ``gemma2_27b``) and MoE
(``granite_moe_1b_a400m``, ``dbrx_132b``) — each the reference's exact public
config. The hybrid, SSM, encoder-decoder and M-RoPE configs come with their
families (``models.registry`` says which ROADMAP item)."""
