"""The paper's core: scheme registry, channel, amplification, OTA aggregate."""
