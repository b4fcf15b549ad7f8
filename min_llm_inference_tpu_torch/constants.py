"""Framework-wide constants.

The port's own copy of min_llm_inference_tpu/constants.py (the port imports
nothing of the JAX package). Values are contracts shared with the reference
engine, so both packages must keep them equal.
"""

# Sentinel written to the decode-result row of an empty batch slot
# (reference: EMPTY_ROW_TOKEN_ID, constants.h; decoder.cu:33-38).
EMPTY_ROW_TOKEN_ID: int = -1

# Token id whose emission terminates a sequence
# (reference: EOF_TOKEN_ID = 1023, constants.h).
EOF_TOKEN_ID: int = 1023

# Tokens per KV page (reference PAGE_BLOCK_SIZE = 16, constants.h); the
# default of EngineConfig.page_size.
DEFAULT_PAGE_SIZE: int = 16

# Minimum pages granted to a newly admitted request
# (reference: DEFAULT_INIT_NUM_BLOCKS = 4, constants.h;
# paged_item_storage.cpp:89-101).
DEFAULT_INIT_NUM_BLOCKS: int = 4
