"""repro_torch.configs — operating points. Only the paper's own workload
(``psram_mttkrp``) is ported; the LM architecture configs of the reference
package come with the models."""
