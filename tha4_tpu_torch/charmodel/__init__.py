from tha4_tpu_torch.charmodel.character_model import CharacterModel

__all__ = ["CharacterModel"]
