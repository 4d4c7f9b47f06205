"""The protocols of the paper's tables and figures on the port's modules."""
