from .mappings import FieldType, Mappings
from .pack import BLOCK, PackBuilder, ShardPack

__all__ = ["BLOCK", "FieldType", "Mappings", "PackBuilder", "ShardPack"]
