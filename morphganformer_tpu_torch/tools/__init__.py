"""The port's weight tools, each a module run with `python -m`:

    convert_checkpoint  a reference GANformer .pkl (the torch persistence
                        dict, plain or zipfile, or the TF-legacy tuple) ->
                        arch.json + <role>.msgpack
    convert_iresnet     an ArcFace iresnet state dict -> .npz
    convert_inception   a torchvision InceptionV3 state dict -> .npz
    convert_facenet     a facenet_pytorch InceptionResnetV1 state dict -> .npz
    convert_mdf         the reference's pickled MDF discriminator stacks -> .npz
    convert_lpips       an LPIPS tower state dict and its linear heads -> .npz
    train_landmarks     trains the landmark net on synthetic faces -> .npz

They take the arguments of the JAX package's scripts of the same names under
tools/ and write the same files, which either package reads. They need torch,
numpy and scipy only: no JAX, flax, optax, torchvision or network.
"""
