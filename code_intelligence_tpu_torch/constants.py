"""Wire/artifact contract constants (no imports)."""

# Downstream classifier heads consume the first 1600 dims of the 2400-d
# pooled embedding (`py/code_intelligence/embeddings.py:116`,
# `py/label_microservice/repo_specific_model.py:182`).
EMBED_TRUNCATE_DIM = 1600
