"""The data layer (numpy + scipy): synthetic scenes, SEM resampling, the
pairs of the benchmark suite, the KITTI / nuScenes readers, pair
registries and datasets, collation, SEM preprocessing and the nuScenes
exporter."""
