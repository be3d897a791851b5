"""The paper's experiment models, and the model zoo's dense decoders."""
