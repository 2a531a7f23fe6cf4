from .ingest import MEAN, STD, device_ingest
from .synthetic import SyntheticLipDataset
from .transforms import make_train_plans
