"""The paper's optimizer (Algorithm 1) and its quantizers."""
