from . import beam_search_decoder
from .beam_search_decoder import *

__all__ = beam_search_decoder.__all__
