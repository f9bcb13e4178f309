from .convert import flax_to_torch, read_engine_spec
from .model import CLIP, CONFIGS, IMAGE_RESOLUTION, MAX_TEXT_LENGTH, MODELS
from .tokenizer import Char97Tokenizer, build_tokenizer, tokenize
