"""The training data path: packed token shards and a step-indexed pipeline (numpy)."""
