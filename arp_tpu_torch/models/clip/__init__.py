from .convert import convert_torch_clip_vars, flax_to_torch, read_engine_spec
from .model import CLIP, CONFIGS, IMAGE_RESOLUTION, MAX_TEXT_LENGTH, MODELS, load_model_vars
from .tokenizer import Char97Tokenizer, build_tokenizer, tokenize
