"""The paper's experiment models."""
