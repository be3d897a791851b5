"""Model configurations of the model zoo: ``ModelConfig`` and the registry."""
