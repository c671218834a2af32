"""Models of the port: the decoder families (dense, MoE, hybrid, xLSTM) and
the paper's toy models."""
