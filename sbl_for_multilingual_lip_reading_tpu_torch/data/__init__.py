from .ingest import MEAN, STD, device_ingest
