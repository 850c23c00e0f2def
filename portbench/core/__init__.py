"""The harness: traffic, weights, the open-loop client, the trace's
reduction, the correctness check and the frozen work formulas."""
