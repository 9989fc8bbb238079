"""The mesh plane: a ('key', 'win') mesh of logical shards
(:mod:`.mesh`) and the sharded window engine over it (:mod:`.sharded`)."""
