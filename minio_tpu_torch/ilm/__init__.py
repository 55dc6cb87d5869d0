"""ILM: bucket lifecycle configuration and evaluation."""
