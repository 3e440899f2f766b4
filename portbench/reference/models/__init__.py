"""The reference's models, one file each: ``<model>.py`` defines
``build(cfg) -> Model`` for a configuration file whose ``"model"`` is
``<model>``."""
