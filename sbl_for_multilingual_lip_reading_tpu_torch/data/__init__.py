from .datasets import Lrw1000Dataset, LrwDataset, MixedBilingualDataset
from .ingest import MEAN, STD, device_ingest
from .pipeline import Batcher, background_iter, prefetch_to_device
from .sampler import TwoStreamBatchSampler
from .synthetic import SyntheticLipDataset, SyntheticPatternDataset
from .transforms import make_train_plans
